"""Host time a request spent waiting for the card's results and copying
them back (the port's ``device.fetch`` span)."""


def read(r):
    return r.per_request_ms("device.fetch")
