"""The share of the executor's result-cache lookups that needed no
computation: (lookups - computed steps) over lookups, from the window's
counts of the ``query.cache.probe`` and ``query.step`` spans. A lookup
answered by joining the same step computing in another query counts as a
hit."""


def read(r):
    probes, _ = r.timer("query.cache.probe")
    steps, _ = r.timer("query.step")
    if probes <= 0:
        return None
    return (probes - steps) / probes * 100.0
