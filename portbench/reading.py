"""What a metric's reader (``metrics/<name>.py``, ``read(reading)``) is
given: the window's requests, in a traced window the device's figures, and
the port's own counters before and after the window. A reader that finds
nothing to read returns None, and the metric is left out of the line."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from .trace import DeviceWindow


@dataclass
class Reading:
    seconds: float  # the window's length
    completed: int  # requests completed inside the window, not failed
    setup_s: float  # from the harness's first line to the window's open
    latencies_ms: np.ndarray  # of those requests, call to return
    least_s: Optional[float]  # their logical work's least device time, summed
    device: Optional[DeviceWindow]  # None unless the window was traced
    timings_before: Dict[str, dict]  # tracing.timings() at the open
    timings_after: Dict[str, dict]  # ... and at the close
    pack_before: dict  # store.PACK_CACHE.stats() at the open
    pack_after: dict  # ... and at the close

    def timer(self, name: str):
        """(calls, seconds) of the port's host timer ``name`` inside the
        window."""
        a = self.timings_after.get(name, {"count": 0, "total_s": 0.0})
        b = self.timings_before.get(name, {"count": 0, "total_s": 0.0})
        return a["count"] - b["count"], a["total_s"] - b["total_s"]

    def per_request_ms(self, name: str) -> Optional[float]:
        calls, secs = self.timer(name)
        if calls <= 0 or self.completed <= 0:
            return None
        return secs / self.completed * 1e3
