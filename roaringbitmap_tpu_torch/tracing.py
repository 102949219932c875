"""Profiling and tracing: a ``torch.profiler`` window, named ranges and
host-phase timers.

Counterpart of ``roaringbitmap_tpu/tracing.py``. Three layers:

* ``trace(logdir)`` — a ``torch.profiler.profile`` window over the
  enclosed block. It records CPU activity and, when a card is present,
  CUDA activity (kernels, copies), and writes a Chrome trace into
  ``logdir`` when the block exits. The profile object is yielded, so the
  caller can also read ``key_averages()``.
* ``annotate(name)`` — a ``torch.profiler.record_function`` range, so a
  host-side phase (packing, the unpack) shows up by name between the
  kernels of a profiler trace, plus an ``op_timer`` of the same name.
* ``op_timer(name)`` / ``timings()`` — wall-clock accounting of
  host-visible phases, queryable without a profile. Combined with
  ``insights.dispatch_counters()`` (kernels, layouts, transfer bytes) this
  answers "where did the time go, which path served it, how many bytes
  moved".

The recording substrate is ``observe/``: every ``op_timer`` block lands in
the locked registry histogram ``rb_tpu_host_op_seconds`` (flat name) and,
through ``observe.spans``, in ``rb_tpu_span_seconds`` (nested ``/``-joined
path), so the JSONL / Prometheus exporters see host phases with no extra
wiring. ``timings()`` is a view of the registry.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator

from . import observe as _observe
from .observe import spans as _spans

_OP_SECONDS = _observe.histogram(
    _observe.HOST_OP_SECONDS,
    "Wall time of named host-side phases (op_timer)",
    ("name",),
)

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str = "rb_tpu_trace") -> Iterator[object]:
    """``torch.profiler`` window over the enclosed block; the Chrome trace
    lands in ``logdir/trace.json`` (open it in Perfetto). Device activity
    is recorded whenever a card is present. Yields the
    ``torch.profiler.profile`` object."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named range in a profiler trace (``torch.profiler.record_function``)
    plus an ``op_timer`` of the same name."""
    import torch

    with torch.profiler.record_function(name), op_timer(name):
        yield


@contextlib.contextmanager
def op_timer(name: str) -> Iterator[None]:
    """Accumulate wall time for a named host-side phase, into the flat
    ``rb_tpu_host_op_seconds`` histogram and the nested
    ``rb_tpu_span_seconds`` through the span stack."""
    t0 = time.perf_counter()
    try:
        with _spans.span(name):
            yield
    finally:
        _OP_SECONDS.observe(time.perf_counter() - t0, (name,))


def timings() -> Dict[str, Dict[str, float]]:
    """{name: {count, total_s, mean_ms}} for all recorded phases (a view
    of the ``rb_tpu_host_op_seconds`` registry histogram)."""
    return {
        name: {
            "count": st["count"],
            "total_s": round(st["sum"], 6),
            "mean_ms": round(st["sum"] / st["count"] * 1e3, 3) if st["count"] else 0.0,
        }
        for (name,), st in _OP_SECONDS.series().items()
    }


def reset_timings() -> None:
    _OP_SECONDS.clear()
    _spans.reset_spans()
