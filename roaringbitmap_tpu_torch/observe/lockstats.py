"""Lock-wait observatory: wait-time histograms over the framework locks.

Counterpart of ``roaringbitmap_tpu/observe/lockstats.py``. Each framework
lock can be wrapped in a :class:`TimedLock` proxy that times ``acquire``
into ``rb_tpu_lock_wait_seconds{lock}`` — a latency histogram, so the p99
wait under a thread hammer is one registry read.

Cost, by mode:

* **not installed** (the default) — the raw locks are untouched;
* **installed, timing disabled** — one module-int compare per acquire on
  top of the proxy call;
* **installed + enabled** — ``perf_counter_ns`` before and after the inner
  acquire plus one histogram observe per sampled acquisition.
  ``RB_TPU_LOCK_TIMING=<n>`` samples every n-th acquisition per lock
  (default 1 = all).

The histogram observe runs *after* the inner lock is held, adding only
``<wrapped lock> -> observe.registry`` edges, an order every instrumented
module already takes. The registry lock itself is wrapped too: it is an
``RLock``, and the proxy forwards ``acquire`` / ``release`` to it, so the
wrapped lock stays reentrant; its own observe re-enters through the proxy
and a thread-local guard breaks the recursion.

``install()`` patches every live reference (module globals, the registry
plus every registered metric's captured ``_lock``, class attributes);
``uninstall()`` restores the originals. The JAX package wraps seven locks;
the port has six: its ``tracing`` timings are a view of the registry and
hold no lock of their own (ROADMAP, departures).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

from . import registry as _registry
from .histogram import latency_histogram

_LOCK_WAIT = latency_histogram(
    _registry.LOCK_WAIT_SECONDS,
    "Time spent waiting to acquire a framework lock, by lock name",
    ("lock",),
)

# 0 = timing off (int compare only); >0 = sample every n-th acquisition
_TIMING = 0

# breaks the registry-lock recursion: observing the wait histogram
# acquires the (wrapped) registry lock, which must not re-observe
_TLS = threading.local()


class TimedLock:
    """Proxy over a Lock/RLock that times (sampled) acquire waits."""

    __slots__ = ("name", "_inner", "_n")

    def __init__(self, name: str, inner):
        self.name = name
        self._inner = inner
        self._n = 0  # unsynchronized sample counter: skew is harmless

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        sample = _TIMING
        if not sample:
            return self._inner.acquire(blocking, timeout)
        self._n += 1
        if self._n % sample or getattr(_TLS, "busy", False):
            return self._inner.acquire(blocking, timeout)
        t0 = time.perf_counter_ns()
        got = self._inner.acquire(blocking, timeout)
        dur = time.perf_counter_ns() - t0
        if got:
            _TLS.busy = True
            try:
                _LOCK_WAIT.observe(dur / 1e9, (self.name,))
            finally:
                _TLS.busy = False
        return got

    def release(self) -> None:
        self._inner.release()

    def __enter__(self) -> "TimedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<TimedLock {self.name} over {self._inner!r}>"


def enable(on: bool = True, sample: Optional[int] = None) -> None:
    """Turn wait timing on/off (requires :func:`install` for any effect).
    ``sample=n`` times every n-th acquisition per lock."""
    global _TIMING
    if sample is not None and sample < 1:
        raise ValueError(f"sample must be >= 1, got {sample}")
    if on:
        _TIMING = int(sample) if sample is not None else (_TIMING or 1)
    else:
        _TIMING = 0


def timing_enabled() -> bool:
    return _TIMING > 0


def _framework_locks() -> List[tuple]:
    """Late-bound ``(name, get, set)`` accessors for the six framework
    locks, patched in place. Imports are local so this module stays
    importable before the heavy modules."""
    from .. import native
    from ..parallel import aggregation
    from ..query import cache as qcache
    from ..query import exec as qexec
    from ..query import expr as qexpr

    def mod(m, attr):
        return (lambda: getattr(m, attr)), (lambda v: setattr(m, attr, v))

    return [
        ("observe.registry", *mod(_registry.REGISTRY, "_lock")),
        ("query.expr.intern", *mod(qexpr, "_INTERN_LOCK")),
        ("query.exec.plan_memo", *mod(qexec, "_PLAN_MEMO_LOCK")),
        ("query.cache", *mod(qcache.DEFAULT_CACHE, "_lock")),
        ("agg.pool", *mod(aggregation.ParallelAggregation, "_POOL_LOCK")),
        ("native.loader", *mod(native, "_LOCK")),
    ]


_INSTALLED: Dict[str, tuple] = {}  # name -> (TimedLock, restore-setter)
_INSTALL_LOCK = threading.Lock()


def install(enable_timing: bool = True, sample: Optional[int] = None) -> None:
    """Wrap the framework locks in :class:`TimedLock` proxies
    (idempotent). Metrics capture the registry lock at registration, so
    every already-registered metric's ``_lock`` is re-pointed at the
    wrapped registry lock; metrics registered afterwards capture the
    wrapped lock through ``Registry._register``."""
    with _INSTALL_LOCK:
        for name, get, set_ in _framework_locks():
            if name in _INSTALLED:
                continue
            inner = get()
            if isinstance(inner, TimedLock):  # foreign wrap: leave it
                continue
            wrapped = TimedLock(name, inner)
            set_(wrapped)
            _INSTALLED[name] = (wrapped, set_)
        reg_entry = _INSTALLED.get("observe.registry")
        if reg_entry is not None:
            wrapped = reg_entry[0]
            for m in _registry.REGISTRY.metrics():
                if m._lock is wrapped._inner:
                    m._lock = wrapped
    if enable_timing:
        enable(True, sample=sample)


def uninstall() -> None:
    """Restore the raw locks and stop timing (idempotent)."""
    enable(False)
    with _INSTALL_LOCK:
        reg_entry = _INSTALLED.get("observe.registry")
        if reg_entry is not None:
            wrapped = reg_entry[0]
            for m in _registry.REGISTRY.metrics():
                if m._lock is wrapped:
                    m._lock = wrapped._inner
        for _name, (wrapped, set_) in list(_INSTALLED.items()):
            set_(wrapped._inner)
        _INSTALLED.clear()


def installed() -> List[str]:
    with _INSTALL_LOCK:
        return sorted(_INSTALLED)


def wait_stats() -> Dict[str, dict]:
    """{lock: {count, sum, p50, p90, p99}} over the recorded waits."""
    out: Dict[str, dict] = {}
    for lv, st in sorted(_LOCK_WAIT.series().items()):
        out[lv[0]] = {
            "count": st["count"],
            "sum": round(st["sum"], 9),
            **{k: round(v, 9) for k, v in _LOCK_WAIT.quantiles(lv).items()},
        }
    return out


def _init_from_env() -> None:
    raw = os.environ.get("RB_TPU_LOCK_TIMING", "").strip().lower()
    if not raw or raw in ("0", "off", "false", "no"):
        return
    try:
        sample = max(1, int(raw))
    except ValueError:
        sample = 1
    install(enable_timing=True, sample=sample)


# the env-driven install runs on the first explicit import of this module
# (``observe`` does not import it), so the package import stays light
_init_from_env()
