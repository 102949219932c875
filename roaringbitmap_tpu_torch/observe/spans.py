"""Nested span tracer: wall-time histograms per span *path*.

Counterpart of ``roaringbitmap_tpu/observe/spans.py``. A span is a named
region of host execution. Spans nest: each thread keeps a stack, and a
span's histogram label is its ``/``-joined path from the stack root
("store.reduce.padded/..."), so after a run the registry answers not only
"how long did packing take" but "packing under which caller". Recording
happens in the registry histogram ``rb_tpu_span_seconds``
(observe/registry.py) — ``snapshot()`` and the exporters see spans with
no extra wiring.

``span(name, trace=True)`` additionally opens a
``torch.profiler.record_function`` range, so the same region shows up by
name in a ``torch.profiler`` trace beside the kernels it launched (the
composition point with ``tracing.annotate``).

Thread-local stacks mean concurrent spans never corrupt each other's
paths; the histogram itself is locked by the registry.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Iterator, List

from . import registry as _registry
from . import timeline as _timeline

SPAN_SECONDS = _registry.histogram(
    _registry.SPAN_SECONDS,
    "Wall time of nested host spans, labeled by /-joined span path",
    ("name",),
)

_local = threading.local()


def _stack() -> List[str]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def current_path() -> str:
    """The /-joined path of the innermost active span ("" outside any)."""
    return "/".join(_stack())


def depth() -> int:
    """How many spans are open on this thread."""
    return len(_stack())


@contextlib.contextmanager
def span(name: str, trace: bool = False) -> Iterator[str]:
    """Time the enclosed block under ``name`` nested below the active span.

    Yields the full span path. ``trace=True`` also opens a
    ``torch.profiler.record_function(name)`` range."""
    ctx = contextlib.nullcontext()
    if trace:
        import torch

        ctx = torch.profiler.record_function(name)
    stack = _stack()
    stack.append(name)
    path = "/".join(stack)
    t0_ns = time.perf_counter_ns()
    try:
        with ctx:
            yield path
    finally:
        stack.pop()
        dur_ns = time.perf_counter_ns() - t0_ns
        SPAN_SECONDS.observe(dur_ns / 1e9, (path,))
        # mirror into the flight recorder so every op_timer/span block
        # appears on the timeline with no wiring of its own
        if _timeline.enabled():
            _timeline._record_complete(name, "span", t0_ns, dur_ns, None)


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
