"""Host time a request in the port's query planner (its ``query.plan``
timer)."""


def read(r):
    return r.per_request_ms("query.plan")
