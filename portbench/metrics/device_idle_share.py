"""The share of the window in which no kernel, copy or set ran on the
card: the window less the union of the device's intervals, over the
window."""


def read(r):
    if r.device is None or r.device.window_s <= 0:
        return None
    return (r.device.window_s - r.device.busy_s) / r.device.window_s * 100.0
