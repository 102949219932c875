"""Time a request in the port's device andnot step, the minuend's re-pack
included (its ``query.andnot.device`` timer)."""


def read(r):
    return r.per_request_ms("query.andnot.device")
