"""The 95th percentile of the latency, call to return, of every request
completed inside the window."""

import numpy as np


def read(r):
    return float(np.percentile(r.latencies_ms, 95))
