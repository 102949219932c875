"""The least time the window's logical work needs on the card (counted by
the request kind from the requests' shapes, ``bounds``), over the time in
which a kernel ran in the window."""


def read(r):
    if r.device is None or not r.least_s or r.device.kernel_s <= 0:
        return None
    return r.least_s / r.device.kernel_s * 100.0
