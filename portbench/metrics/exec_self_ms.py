"""Host time a request in the port's executor itself: the self time of its
``query.execute`` span (its duration less what the spans it opens cover:
cache probes and publications, the steps, the fetches), the executor's own
bookkeeping."""


def read(r):
    a = r.timings_after.get("query.execute", {})
    b = r.timings_before.get("query.execute", {})
    if "self_s" not in a or r.completed <= 0 or a["count"] - b.get("count", 0) <= 0:
        return None
    return (a["self_s"] - b.get("self_s", 0.0)) / r.completed * 1e3
