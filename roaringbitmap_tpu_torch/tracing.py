"""Profiling and tracing: a ``torch.profiler`` window and host-phase
timers.

Counterpart of ``roaringbitmap_tpu/tracing.py``. Two layers:

* ``trace(logdir)`` — a ``torch.profiler.profile`` window over the
  enclosed block. It records CPU activity and, when a card is present,
  CUDA activity (kernels, copies), and writes a Chrome trace into
  ``logdir`` when the block exits. The profile object is yielded, so the
  caller can also read ``key_averages()``.
* ``op_timer(name)`` / ``timings()`` — wall-clock accounting of
  host-visible phases, queryable without a profile. ``op_timer`` is an
  ``observe.spans.span``: inside a profiler window it is also a named
  range between the kernels it launched, on the profiler's clock.
  ``annotate`` is its alias. Combined with ``insights.dispatch_counters()``
  (kernels, layouts, transfer bytes) this answers "where did the time go,
  which path served it, how many bytes moved".

The recording substrate is ``observe/``: every span (``op_timer``, and the
``timeline.stage`` blocks of the pack and delta pipelines) lands in the
locked registry histogram ``rb_tpu_host_op_seconds`` (flat name, with each
span's self time) and in ``rb_tpu_span_seconds`` (nested ``/``-joined
path), so the JSONL / Prometheus exporters see host phases with no extra
wiring. ``timings()`` is a view of the registry.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterator

from .observe import spans as _spans

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


def op_timer(name: str) -> _spans.Span:
    """Accumulate wall time for a named host-side phase: a span, so into
    the flat ``rb_tpu_host_op_seconds`` histogram and the nested
    ``rb_tpu_span_seconds``, and a profiler range while one records."""
    return _spans.Span(name)


annotate = op_timer


def timings() -> Dict[str, Dict[str, float]]:
    """{name: {count, total_s, mean_ms, self_s}} for all recorded phases (a
    view of the ``rb_tpu_host_op_seconds`` registry histogram). ``self_s``
    is the phase's total less the time its child spans on the same thread
    cover."""
    return {
        name: {
            "count": st["count"],
            "total_s": round(st["sum"], 6),
            "mean_ms": round(st["sum"] / st["count"] * 1e3, 3) if st["count"] else 0.0,
            "self_s": round(st.get("self", 0.0), 6),
        }
        for (name,), st in _spans.HOST_OP_SECONDS.series().items()
    }


def reset_timings() -> None:
    _spans.HOST_OP_SECONDS.clear()
    _spans.reset_spans()
