"""Build observatory: counts each compile of the package's native
libraries.

Counterpart of ``roaringbitmap_tpu/observe/compilewatch.py``, which counts
every XLA trace of the JAX package's jitted entry points. This package has
no jit: its only compile step is the first-use build of each library —
``ops/_build.py``'s ``nvcc`` build of the CUDA kernels and the native host
tier's ``g++`` build. ``tracked(name)`` wraps the function that runs the
compilers, so every build that really compiles (not one that finds its
library on disk) counts one into ``rb_tpu_compile_total{fn}``. A steady
state that rebuilds nothing reads 0 across its window — what the JAX
counter proves for retraces.

**Anomaly hook**: when any fn's count passes the budget
(``RB_TPU_COMPILE_BUDGET``, default 32; ``configure(budget=...)``;
``<= 0`` disables), the flight recorder flushes to a JSONL artifact
(``RB_TPU_COMPILE_DUMP``, default ``rb_tpu_compile_anomaly.jsonl`` inside
the ``RB_TPU_ARTIFACT_DIR`` sink — see ``observe.artifacts``) with the
offending fn in the trigger header. Dumps are throttled to one per
second; ``rb_tpu_timeline_anomaly_total{cat="compile"}`` counts every
overrun regardless.

``compile_counts()`` is the read API.
"""

from __future__ import annotations

import functools
import os
import threading
import time
from typing import Callable, Dict, Optional

from . import registry as _registry
from . import timeline as _timeline

_COMPILE_TOTAL = _registry.counter(
    _registry.COMPILE_TOTAL,
    "Builds (compiler runs) of tracked native libraries",
    ("fn",),
)

DEFAULT_BUDGET = 32


def _init_budget() -> int:
    raw = os.environ.get("RB_TPU_COMPILE_BUDGET")
    try:
        return int(raw) if raw else DEFAULT_BUDGET
    except ValueError:  # malformed env must not break package import
        return DEFAULT_BUDGET


_BUDGET = _init_budget()
_DUMP_PATH = os.environ.get("RB_TPU_COMPILE_DUMP") or "rb_tpu_compile_anomaly.jsonl"

_THROTTLE_LOCK = threading.Lock()
_LAST_DUMP_NS = 0  # guarded-by: _THROTTLE_LOCK
_DUMP_MIN_INTERVAL_NS = 1_000_000_000


def configure(
    budget: Optional[int] = None, dump_path: Optional[str] = None
) -> None:
    """Runtime overrides: ``budget <= 0`` disables the anomaly hook."""
    global _BUDGET, _DUMP_PATH
    if budget is not None:
        _BUDGET = int(budget)
    if dump_path is not None:
        _DUMP_PATH = dump_path


def tracked(name: str) -> Callable:
    """Decorator counting each call of the wrapped build function (one
    that runs the compilers) as one build of ``name``."""

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            _note_trace(name)
            return fn(*args, **kwargs)

        return wrapper

    return deco


def _note_trace(name: str) -> None:
    _COMPILE_TOTAL.inc(1, (name,))
    total = _COMPILE_TOTAL.get((name,))
    if _timeline.enabled():
        _timeline.instant("compile.trace", "compile", fn=name, total=total)
    if _BUDGET > 0 and total > _BUDGET:
        _anomaly(name, total)


def _anomaly(name: str, total: int) -> None:
    global _LAST_DUMP_NS
    _timeline._ANOMALY_TOTAL.inc(1, ("compile",))
    _timeline.instant(
        "compile.anomaly", "anomaly", fn=name, total=total, budget=_BUDGET
    )
    now = time.perf_counter_ns()
    with _THROTTLE_LOCK:
        if _LAST_DUMP_NS and now - _LAST_DUMP_NS < _DUMP_MIN_INTERVAL_NS:
            return
        _LAST_DUMP_NS = now
        path = _DUMP_PATH
    try:
        _timeline.dump_jsonl(
            path,
            trigger={"compile_fn": name, "traces": total, "budget": _BUDGET},
        )
    except OSError:  # diagnostics must never fail a build; the anomaly counter above already recorded the overrun
        pass


def compile_counts() -> Dict[str, int]:
    """{fn: builds-so-far} for every tracked library."""
    return {lv[0]: int(v) for lv, v in _COMPILE_TOTAL.series().items()}


def reset_counts() -> None:
    """Clear the per-fn series (tests; the metric stays registered)."""
    _COMPILE_TOTAL.clear()
