"""Deterministic, thread-safe fault injection for the pack/query pipeline.

Counterpart of ``roaringbitmap_tpu/robust/faults.py``. Named **fault
sites** are threaded through the real pipeline; each site is one
``fault_point(site)`` call at the place a production failure would
surface (the host-to-device copy, the device expansion, the kernel
launch, the cache-budget admission). When no injection is active a fault
point is ONE module-int compare.

Two ways to arm faults:

* **Scoped**: ``with inject("store.ship", TransientDeviceError, every=3):``
  — a context manager installing one rule (``every=`` k-th hit, ``after=``
  all hits past the first k, ``prob=`` seeded pseudo-probability,
  ``times=`` total-fire cap). Rules are global (faults cross threads,
  like real ones) but owned per scope, so overlapping scopes compose.
* **Seeded schedule**: ``RB_TPU_FAULTS=<seed-name>[:prob[:site+site]]``
  installs a chaos schedule at import of ``robust`` — every listed site
  fires with the given probability (default 0.02), the error kind chosen
  per site (budget pressure → ResourceExhausted, device memory →
  ``simulated_oom``, the rest → TransientDeviceError). Decisions are a
  pure function of ``(seed, site, per-site hit index)``, so a replay with
  the same spec makes identical decisions at every site regardless of
  thread interleaving — the same decisions the JAX package makes for the
  same spec.

``suspended()`` masks every fault on the current thread (a no-fault
reference run mid-schedule).

:data:`SITES` lists the sites that have a call site in this package. The
JAX package's other sites (``query.fusion``, ``query.hedge``,
``serve.admit``, ``epoch.flip``, ``columnar.kernel``, ``columnar.device``,
``native.entry``, ``serve.maintain``, ``durable.persist``) come with the
modules that call them (ROADMAP Queue A).
"""

from __future__ import annotations

import os
import threading
import zlib
from typing import Dict, List, Tuple

from .. import observe as _observe
from ..observe import timeline as _timeline
from .errors import ResourceExhausted, TransientDeviceError, simulated_oom

# The registered fault sites, each one real call site in the pipeline.
# fault_point() on an unregistered site raises loudly — a typo'd site
# would silently never fire.
SITES: Tuple[str, ...] = (
    "store.ship",        # host-to-device copy of packed rows (store.py)
    "store.hbm",         # device allocation during the copy (OOM simulation)
    "store.expand",      # device-side payload expansion, also on the overlap lane
    "ops.dispatch",      # kernel launch: reduce, popcount, expand, threshold (ops/kernels.py)
    "query.exec",        # query executor device-engine step dispatch
    "pack_cache.budget", # resident pack-cache byte-budget admission
)

_FAULT_TOTAL = _observe.counter(
    _observe.FAULT_INJECTED_TOTAL,
    "Faults fired by the injection framework, by site",
    ("site",),
)

_lock = threading.Lock()
# every installed rule, newest last; fault_point fires the FIRST matching
# rule per hit (rule order is deterministic: install order)
_RULES: List["FaultRule"] = []  # guarded-by: _lock
_SITE_HITS: Dict[str, int] = {}  # guarded-by: _lock
# lock-free fast-path flag: number of installed rules. fault_point reads it
# unlocked — worst case a racing install is seen one call late, exactly
# like a real fault arriving one call later.
_ACTIVE = 0

_TLS = threading.local()  # .suspend: int depth of suspended() scopes


class FaultRule:
    """One armed fault: fires at ``site`` per its schedule.

    ``exc`` may be an exception class, instance, or ``callable(site) ->
    exception``. Exactly one of ``every``/``after``/``prob`` selects hits
    (``every=1`` == every hit); ``times`` caps total fires."""

    __slots__ = ("site", "exc", "every", "after", "prob", "times", "seed", "fired")

    def __init__(self, site, exc, every=None, after=None, prob=None,
                 times=None, seed=0):
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r} (known: {SITES})")
        if sum(x is not None for x in (every, after, prob)) != 1:
            raise ValueError("exactly one of every=/after=/prob= is required")
        if prob is not None and not (0.0 <= prob <= 1.0):
            raise ValueError(f"prob must be in [0, 1], got {prob}")
        if every is not None and every < 1:
            raise ValueError(f"every must be >= 1 (1 == every hit), got {every}")
        if after is not None and after < 0:
            raise ValueError(f"after must be >= 0, got {after}")
        if times is not None and times < 1:
            raise ValueError(f"times must be >= 1, got {times}")
        self.site = site
        self.exc = exc
        self.every = every
        self.after = after
        self.prob = prob
        self.times = times
        self.seed = int(seed)
        self.fired = 0  # guarded-by: _lock

    def _decides(self, hit: int) -> bool:
        """Pure decision for per-site hit index ``hit`` (1-based)."""
        if self.times is not None and self.fired >= self.times:
            return False
        if self.every is not None:
            return hit % self.every == 0
        if self.after is not None:
            return hit > self.after
        # seeded pseudo-probability: crc32 of (seed, site, hit) -> [0, 1).
        # A pure function of the triple, so schedule replay is exact and
        # thread-interleaving-independent (per-site hit order is the only
        # input, and the counter is advanced under the lock).
        h = zlib.crc32(f"{self.seed}:{self.site}:{hit}".encode())
        return (h & 0xFFFFFF) / float(1 << 24) < self.prob

    def _raise(self) -> None:
        e = self.exc
        if callable(e) and not isinstance(e, type):
            raise e(self.site)
        if isinstance(e, type):
            raise e(f"injected fault at site {self.site!r}")
        raise e


def fault_point(site: str) -> None:
    """The pipeline hook: raises this hit's scheduled fault, if any.

    No injection active (the production state): one global-int compare.
    Suspended on this thread: counters do not advance, so the reference
    run is invisible to the schedule."""
    if not _ACTIVE:
        return
    if getattr(_TLS, "suspend", 0):
        return
    with _lock:
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r} (known: {SITES})")
        hit = _SITE_HITS.get(site, 0) + 1
        _SITE_HITS[site] = hit
        rule = None
        for r in _RULES:
            if r.site == site and r._decides(hit):
                r.fired += 1
                rule = r
                break
    if rule is not None:
        _FAULT_TOTAL.inc(1, (site,))
        _timeline.instant("fault.injected", "fault", site=site, hit=hit)
        rule._raise()


def active() -> bool:
    return bool(_ACTIVE)


class inject:
    """Scoped fault rule (context manager)::

        with inject("ops.dispatch", TransientDeviceError, every=1):
            ...  # every device dispatch raises

    Thread-safe and composable: overlapping scopes each install their own
    rule; exiting removes exactly that rule."""

    def __init__(self, site: str, exc=TransientDeviceError, *, every=None,
                 after=None, prob=None, times=None, seed=0):
        self._rule = FaultRule(
            site, exc, every=every, after=after, prob=prob, times=times,
            seed=seed,
        )

    @property
    def fired(self) -> int:
        with _lock:
            return self._rule.fired

    def __enter__(self) -> "inject":
        global _ACTIVE
        with _lock:
            _RULES.append(self._rule)
            _ACTIVE = len(_RULES)
        return self

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        with _lock:
            try:
                _RULES.remove(self._rule)
            except ValueError:  # clear() raced us: already gone
                pass
            _ACTIVE = len(_RULES)


class suspended:
    """Mask every fault point on the current thread (re-entrant): a
    no-fault reference run inside one of these, mid-schedule, does not
    advance the per-site hit counters."""

    def __enter__(self) -> "suspended":
        _TLS.suspend = getattr(_TLS, "suspend", 0) + 1
        return self

    def __exit__(self, *exc) -> None:
        _TLS.suspend -= 1


def clear() -> None:
    """Remove every installed rule and reset the per-site hit counters."""
    global _ACTIVE
    with _lock:
        _RULES.clear()
        _SITE_HITS.clear()
        _ACTIVE = 0


def site_hits() -> Dict[str, int]:
    with _lock:
        return dict(_SITE_HITS)


# ---------------------------------------------------------------------------
# seeded schedules (RB_TPU_FAULTS)
# ---------------------------------------------------------------------------

# per-site error kind for chaos schedules: the failure a production run of
# that site would actually see
_SCHEDULE_ERRORS: Dict[str, object] = {
    "store.hbm": simulated_oom,
    "pack_cache.budget": ResourceExhausted,
}


def schedule_rules(spec: str) -> List[FaultRule]:
    """Parse ``<seed-name>[:prob[:site+site+...]]`` into rules — e.g.
    ``chaos-seed``, ``my-seed:0.1``, ``s1:0.5:store.ship+ops.dispatch``.
    The seed-name hashes to the decision seed, so a named schedule is fully
    reproducible from its spec string alone."""
    parts = spec.split(":")
    seed = zlib.crc32(parts[0].encode())
    prob = float(parts[1]) if len(parts) > 1 and parts[1] else 0.02
    sites = parts[2].split("+") if len(parts) > 2 and parts[2] else list(SITES)
    rules = []
    for site in sites:
        exc = _SCHEDULE_ERRORS.get(site, TransientDeviceError)
        rules.append(FaultRule(site, exc, prob=prob, seed=seed))
    return rules


def install(spec: str) -> None:
    """Install a seeded schedule (replacing any current rules)."""
    global _ACTIVE
    rules = schedule_rules(spec)
    with _lock:
        _RULES.clear()
        _SITE_HITS.clear()
        _RULES.extend(rules)
        _ACTIVE = len(_RULES)


def install_env_schedule() -> bool:
    """Arm the ``RB_TPU_FAULTS`` schedule, if the env var is set (called
    once at package import). Returns whether a schedule was installed."""
    spec = os.environ.get("RB_TPU_FAULTS", "").strip()
    if not spec:
        return False
    install(spec)
    return True
