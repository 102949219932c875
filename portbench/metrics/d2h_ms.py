"""Device-to-host copy time a request, from the profiler's copies."""


def read(r):
    if r.device is None or r.completed <= 0 or r.device.dtoh_s <= 0:
        return None
    return r.device.dtoh_s / r.completed * 1e3
