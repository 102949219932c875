"""Query-scoped trace context.

Counterpart of ``roaringbitmap_tpu/observe/context.py``. Every top-level
pipeline entry — a facade aggregation, ``query.execute``, a pipelined
batch — opens a **trace scope**: a process-unique trace id carried in a
:mod:`contextvars` variable for the dynamic extent of the query.
Everything recorded underneath (flight-recorder spans and instants,
decision-log entries) picks the id up, so a multi-query run decomposes
per query instead of smearing into one aggregate.

Rules:

* a ``trace_scope()`` opened while another is active **reuses** the
  ambient id (a query's internal engine calls are the same query);
  passing an explicit id pins it (the pipelined entry points pre-assign ids so
  query i+1's prefetch work is attributed to query i+1);
* contextvars do NOT cross thread boundaries — worker threads (the
  overlap lane) receive the id by **explicit handoff**: the submitter
  captures ``current_trace()`` into the job, the worker wraps its work in
  ``adopt(trace_id)``;
* ids are process-unique monotonic tokens (``q<serial hex>``), never used
  as a metric label (unbounded label values would grow the registry
  without end); they live on events and decisions, which are bounded
  rings.

Off-mode cost: ``current_trace()`` is one module-bool check plus a C
``ContextVar.get``; ``configure(enabled=False)`` short-circuits to
``None`` before the get.
"""

from __future__ import annotations

import contextvars
import itertools
from typing import Optional

_TRACE: "contextvars.ContextVar[Optional[str]]" = contextvars.ContextVar(
    "rb_tpu_trace", default=None
)

# itertools.count.__next__ is atomic under the GIL: no lock needed
_SERIAL = itertools.count(1)

_ENABLED = True


def configure(enabled: Optional[bool] = None) -> None:
    """Kill switch for an observability-off run: disabled,
    ``current_trace()`` returns None and ``trace_scope`` is a no-op."""
    global _ENABLED
    if enabled is not None:
        _ENABLED = bool(enabled)


def enabled() -> bool:
    return _ENABLED


def new_trace_id() -> str:
    """Mint a process-unique trace id (monotonic serial, hex)."""
    return "q%06x" % next(_SERIAL)


def current_trace() -> Optional[str]:
    """The active trace id on this thread/context, or None."""
    if not _ENABLED:
        return None
    return _TRACE.get()


class trace_scope:
    """Ensure a trace id is active for the enclosed block.

    With no argument: reuse the ambient id if one is active (nested entry
    points belong to the enclosing query), else mint a fresh one. With an
    explicit ``trace_id``: pin it for the block regardless (the pipelined
    entry points' pre-assigned per-query ids). Re-entrant and exception-safe;
    ``self.trace_id`` is the id in effect inside the block."""

    __slots__ = ("_explicit", "_token", "trace_id")

    def __init__(self, trace_id: Optional[str] = None):
        self._explicit = trace_id
        self._token = None
        self.trace_id = None

    def __enter__(self) -> "trace_scope":
        if not _ENABLED:
            return self
        if self._explicit is None:
            cur = _TRACE.get()
            if cur is not None:
                self.trace_id = cur  # nested: same query, no token to reset
                return self
            self.trace_id = new_trace_id()
        else:
            self.trace_id = self._explicit
        self._token = _TRACE.set(self.trace_id)
        return self

    def __exit__(self, *exc) -> None:
        if self._token is not None:
            _TRACE.reset(self._token)
            self._token = None


class adopt:
    """Explicit cross-thread handoff: run a worker-thread block under the
    submitting query's trace id (captured by the submitter with
    ``current_trace()`` and carried in the job). ``adopt(None)`` is a
    no-op, so call sites need no conditional."""

    __slots__ = ("_trace_id", "_token")

    def __init__(self, trace_id: Optional[str]):
        self._trace_id = trace_id
        self._token = None

    def __enter__(self) -> "adopt":
        if _ENABLED and self._trace_id is not None:
            self._token = _TRACE.set(self._trace_id)
        return self

    def __exit__(self, *exc) -> None:
        if self._token is not None:
            _TRACE.reset(self._token)
            self._token = None
