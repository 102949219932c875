"""Nested spans: the one primitive that times a region of host work.

Counterpart of ``roaringbitmap_tpu/observe/spans.py``. A span is a named
region of host execution. Spans nest: each thread keeps a stack of open
spans, so each knows its parent, and a span's path is its ``/``-joined
chain from the stack root ("query.execute/query.step/pack.ship"). One
clock read on entry and one on exit feed everything a span records:

* ``rb_tpu_span_seconds{name=<path>}`` — the nested histogram, so the
  registry answers "packing under which caller";
* ``rb_tpu_host_op_seconds{name=<name>}`` — the flat histogram that
  ``tracing.timings()`` shows;
* the span's self time (its duration less what its child spans on the
  same thread cover), summed in the flat histogram's series;
* the caller's own stage histogram, when one is passed
  (``timeline.stage``);
* a flight-recorder event, when ``RB_TPU_TIMELINE`` records, carrying the
  request's trace id;
* a ``torch.profiler.record_function`` range when, and only when, a
  profiler is recording, so the span lands in the profiler's trace beside
  the kernels and copies it caused, on the profiler's clock. With no
  profiler running the guard is one module-flag read.

``tracing.op_timer``, ``timeline.stage`` and ``timeline.tspan`` are thin
wrappers over :class:`Span`. Thread-local stacks mean concurrent spans never
corrupt each other's paths; the histograms are locked by the registry.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import List, Optional

from . import registry as _registry

SPAN_SECONDS = _registry.histogram(
    _registry.SPAN_SECONDS,
    "Wall time of nested host spans, labeled by /-joined span path",
    ("name",),
)


class FlatHistogram(_registry.Histogram):
    """``rb_tpu_host_op_seconds``: a histogram whose series also sum their
    spans' self time (``"self"`` in ``series()``; the exports are those of
    any histogram)."""

    def observe_span(self, secs: float, self_secs: float, labels) -> None:
        with self._lock:
            self.observe(secs, labels)
            st = self._series[self._labels_tuple(labels)]
            st["self"] = st.get("self", 0.0) + self_secs


HOST_OP_SECONDS = _registry.REGISTRY._register(
    FlatHistogram,
    _registry.HOST_OP_SECONDS,
    "Wall time of named host-side phases (op_timer)",
    ("name",),
)

_local = threading.local()

# torch.autograd.profiler once torch is imported; no profiler can record
# before that, so the observe package stays free of a torch import
_profiler_module = None


def _profiling() -> bool:
    """Is a ``torch.profiler`` window recording? The module flag is set for
    the whole process (every thread) while a profile is active."""
    global _profiler_module
    mod = _profiler_module
    if mod is None:
        mod = _profiler_module = sys.modules.get("torch.autograd.profiler")
        if mod is None:
            return False
    return getattr(mod, "_is_profiler_enabled", False)


def _stack() -> List["Span"]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class Span:
    """One timed region. Entering yields the span's path; a subclass may
    yield itself (``timeline.tspan``, whose callers attach attrs)."""

    __slots__ = ("name", "cat", "attrs", "path", "_hist", "_labels", "_t0",
                 "_child_ns", "_range")

    def __init__(self, name: str, cat: str = "span", hist=None, labels=(),
                 attrs: Optional[dict] = None):
        self.name = name
        self.cat = cat
        self.attrs = attrs
        self._hist = hist
        self._labels = labels

    def __enter__(self):
        stack = _stack()
        self.path = stack[-1].path + "/" + self.name if stack else self.name
        stack.append(self)
        self._child_ns = 0
        self._range = None
        if _profiling():
            import torch

            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self.path

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        stack = _stack()
        stack.pop()
        if stack:
            stack[-1]._child_ns += dur
        secs = dur / 1e9
        SPAN_SECONDS.observe(secs, (self.path,))
        HOST_OP_SECONDS.observe_span(secs, (dur - self._child_ns) / 1e9, (self.name,))
        if self._hist is not None:
            self._hist.observe(secs, self._labels)
        if _timeline.enabled():
            _timeline._record_complete(self.name, self.cat, self._t0, dur, self.attrs or None)
        return False


def span(name: str, cat: str = "span", hist=None, labels=(), **attrs) -> Span:
    """Time the enclosed block under ``name``, nested below the active span;
    ``with`` yields the full span path. ``hist`` (with ``labels``) is a
    stage histogram observed with the same duration; ``cat`` and ``attrs``
    go to the flight-recorder event."""
    return Span(name, cat, hist, labels, attrs)


def current_path() -> str:
    """The /-joined path of the innermost active span ("" outside any)."""
    stack = _stack()
    return stack[-1].path if stack else ""


def depth() -> int:
    """How many spans are open on this thread."""
    return len(_stack())


def span_timings() -> dict:
    """{path: {count, total_s, mean_ms}} over all recorded spans — the
    shape ``tracing.timings()`` uses, keyed by nested path."""
    out = {}
    for (path,), st in sorted(SPAN_SECONDS.series().items()):
        c, total = st["count"], st["sum"]
        out[path] = {
            "count": c,
            "total_s": round(total, 6),
            "mean_ms": round(total / c * 1e3, 3) if c else 0.0,
        }
    return out


def reset_spans() -> None:
    SPAN_SECONDS.clear()


# at the end: timeline subclasses Span, and a span records into timeline
from . import timeline as _timeline  # noqa: E402
