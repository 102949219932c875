"""The device's side of a traced window, from ``torch.profiler``.

The profiler records host activity and the card's kernels and copies
(CUPTI) while the window runs; its Chrome trace is read back here. Busy
time is the union of the device intervals inside the window, never a sum of
their durations (two streams can overlap). A window in which the profiler
saw no device event at all fails: the idle share would be a guess.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Tuple

WINDOW_SPAN = "portbench.window"
KERNEL_CATS = {"kernel"}
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"user_annotation", "cpu_op"}
TOP = 10


class NoDeviceEvents(RuntimeError):
    pass


@dataclass
class DeviceWindow:
    window_s: float
    busy_s: float  # union of kernels, copies and sets
    kernel_s: float  # union of kernels alone
    dtoh_s: float  # summed device-to-host copies
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


@contextlib.contextmanager
def profiled() -> Iterator[dict]:
    """Profile the block; on exit the yielded dict holds ``"trace"``, the
    parsed Chrome trace's events. The file goes to a fresh temporary
    directory, which is removed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    holder: dict = {}
    try:
        # the clients' threads too, so an idle gap is named by what the
        # host was doing there (torch builds that lack it record only the
        # thread that opened the window)
        every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError, RuntimeError):
        every_thread = None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=every_thread) as prof:
        yield holder
    tmp = tempfile.mkdtemp(prefix="portbench_trace_")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            holder["trace"] = json.load(f).get("traceEvents", [])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def _length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def read_window(events: List[dict]) -> DeviceWindow:
    """Reduce a Chrome trace to the window's device figures (seconds)."""
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    marks = [e for e in complete
             if e.get("name") == WINDOW_SPAN and str(e.get("cat", "")).lower() == "user_annotation"]
    if not marks:
        raise NoDeviceEvents(f"the trace holds no {WINDOW_SPAN} span")
    w0 = float(marks[0]["ts"])
    w1 = w0 + float(marks[0]["dur"])
    dev: List[Tuple[float, float, str, str]] = []
    host: List[Tuple[float, float, str]] = []
    for e in complete:
        cat = str(e.get("cat", "")).lower()
        s = float(e["ts"])
        t = s + float(e["dur"])
        if cat in DEVICE_CATS:
            s, t = max(s, w0), min(t, w1)
            if t > s:
                dev.append((s, t, str(e.get("name", "")), cat))
        elif cat in HOST_CATS and e is not marks[0]:
            host.append((s, t, str(e.get("name", ""))))
    if not dev:
        raise NoDeviceEvents("the profiler recorded no kernel or copy inside the window")
    busy = _union([(s, t) for s, t, _, _ in dev])
    kernels = _union([(s, t) for s, t, _, c in dev if c in KERNEL_CATS])
    dtoh = sum(t - s for s, t, n, c in dev if c == "gpu_memcpy" and "dtoh" in n.lower())
    by_name: Dict[str, float] = {}
    for s, t, n, _ in dev:
        by_name[n[:160]] = by_name.get(n[:160], 0.0) + (t - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = []
    edge = w0
    for s, t in busy + [(w1, w1)]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, t)
    gaps.sort(key=lambda g: g[0] - g[1])
    host.sort(key=lambda h: h[1] - h[0])  # innermost span first
    named = []
    for g0, g1 in gaps[:TOP]:
        mid = (g0 + g1) / 2
        name = next((n for s, t, n in host if s <= mid <= t), "no host span")
        named.append((name[:160], (g1 - g0) / 1e6))
    return DeviceWindow(
        window_s=(w1 - w0) / 1e6,
        busy_s=_length(busy) / 1e6,
        kernel_s=_length(kernels) / 1e6,
        dtoh_s=dtoh / 1e6,
        device_ops=[(n, v / 1e6) for n, v in ops],
        idle_gaps=named,
    )
