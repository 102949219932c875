"""Execution-tier ladder: breakers, retries and deadline budgets.

Counterpart of ``roaringbitmap_tpu/robust/ladder.py``. A **site**
(``"agg"``, ``"query.exec"``) runs an ordered list of **tiers** —
callables producing the *same bit-exact result* by different machinery.
:meth:`Ladder.run` walks them top down, with the JAX package's semantics:

* a tier whose circuit breaker is open is skipped (no attempt, no latency
  paid on a path known to be failing);
* a tier that raises is **classified** (robust/errors.py): fatal errors
  re-raise unchanged, everything else records a failure against the
  tier's health, emits ``rb_tpu_degrade_total{site,from,to}`` plus a
  flight-recorder instant, and falls to the next tier;
* the bottom tier is last-resort: it is attempted even when its breaker
  is open, and its failure propagates (there is nothing below).

**The departure: a device tier is always the last tier of its list.** The
JAX package lists the device first and the CPU tiers below it, so a
device failure is answered by a CPU tier. Here a list holds either the
device tier alone or CPU tiers alone (columnar, then per-container, then
pure Python, as the JAX package chains them), so a device failure that
outlives its retries raises, classified, to the caller, and no CPU tier
computes the answer behind it. Which list runs is decided before any tier
runs, by the same rule that picks the JAX package's starting tier.

**Health + breaker** (per site, tier): ``trip_after`` consecutive
failures open the breaker; while open, traffic rides the next tier down
without attempting this one; after ``cooldown_s`` the breaker half-opens
and admits ONE probe — success closes it, failure re-opens it for another
cooldown. Transitions emit ``rb_tpu_breaker_transitions_total{site,tier,
state}``.

**Retry with jittered backoff** (:func:`retry`): for transient-classified
failures on the transfer sites (``store.ship``, ``store.expand``).
Bounded attempts, exponential backoff with deterministic decorrelated
jitter, and deadline-aware — a retry that cannot finish before the
ambient deadline raises now instead of sleeping through the caller's
budget. A retried device call runs on the card again.

**Deadline budgets** (:func:`deadline_scope` / :func:`deadline_expired`):
a per-query wall-clock budget carried in a thread-local; the query
executor checks it before each step and, once it has run out, routes the
remaining steps to their CPU tier before they run — by the clock, never
after a failure. ``rb_tpu_deadline_total{site,outcome}`` counts the
outcomes.

Lock discipline: the ladder's health lock is a leaf — metrics and
recorder writes happen OUTSIDE it, so it never nests over the registry or
recorder locks.
"""

from __future__ import annotations

import threading
import time
import zlib
from typing import Callable, Optional, Sequence, Tuple

from .. import observe as _observe
from ..observe import decisions as _decisions
from ..observe import timeline as _timeline
from .errors import FATAL, TRANSIENT, classify

# canonical tier names, fastest first (the aggregation's rungs); "device"
# is always alone in its list
TIERS: Tuple[str, ...] = ("device", "columnar-cpu", "per-container", "pure-python")

_DEGRADE_TOTAL = _observe.counter(
    _observe.DEGRADE_TOTAL,
    "Degradations routed by the execution-tier ladder (site, failing tier, "
    "tier that absorbed the traffic)",
    ("site", "from", "to"),
)
_BREAKER_TOTAL = _observe.counter(
    _observe.BREAKER_TRANSITIONS_TOTAL,
    "Circuit-breaker state transitions by site, tier, and entered state",
    ("site", "tier", "state"),
)
_RETRY_TOTAL = _observe.counter(
    _observe.RETRY_TOTAL,
    "Retry-loop attempts on transient-classified sites, by outcome "
    "(retried | recovered | exhausted | not_retryable)",
    ("site", "outcome"),
)
_DEADLINE_TOTAL = _observe.counter(
    _observe.DEADLINE_TOTAL,
    "Deadline-budget outcomes by site (met | degraded)",
    ("site", "outcome"),
)

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class Breaker:
    """Per-(site, tier) health tracker + circuit breaker. All state is
    guarded by the owning Ladder's health lock; transition METRICS are
    returned to the caller and emitted outside it (leaf-lock discipline)."""

    __slots__ = ("state", "consecutive", "opened_at", "first_opened_at",
                 "trip_after", "cooldown_s", "probing")

    def __init__(self, trip_after: int, cooldown_s: float):
        self.state = CLOSED
        self.consecutive = 0       # consecutive failures while closed
        self.opened_at = 0.0       # monotonic time of the last trip
        # when the CURRENT unhealthy episode began: set on the CLOSED->OPEN
        # trip, NOT reset by failed half-open probes (each probe failure
        # re-trips and moves opened_at, so opened_at alone can never age
        # past one cooldown under traffic), cleared on recovery
        self.first_opened_at = 0.0
        self.trip_after = trip_after
        self.cooldown_s = cooldown_s
        self.probing = False       # a half-open probe is in flight

    def allow(self, now: float) -> Tuple[bool, Optional[str]]:
        """(admit?, transition-entered-or-None). Open breakers admit one
        half-open probe per cooldown expiry."""
        if self.state == CLOSED:
            return True, None
        if self.state == OPEN and now - self.opened_at >= self.cooldown_s:
            self.state = HALF_OPEN
            self.probing = True
            return True, HALF_OPEN
        if self.state == HALF_OPEN and not self.probing:
            # previous probe concluded elsewhere; admit the next one
            self.probing = True
            return True, None
        return False, None

    def success(self) -> Optional[str]:
        self.consecutive = 0
        self.probing = False
        self.first_opened_at = 0.0
        if self.state != CLOSED:
            self.state = CLOSED
            return CLOSED
        return None

    def failure(self, now: float) -> Optional[str]:
        self.probing = False
        if self.state == HALF_OPEN:
            # failed probe re-trips: the episode continues, its start stays
            self.state = OPEN
            self.opened_at = now
            return OPEN
        self.consecutive += 1
        if self.state == CLOSED and self.consecutive >= self.trip_after:
            self.state = OPEN
            self.opened_at = now
            self.first_opened_at = now
            return OPEN
        return None


class Ladder:
    """The process-wide degradation router (module singleton ``LADDER``)."""

    def __init__(self, trip_after: int = 3, cooldown_s: float = 5.0):
        self.trip_after = int(trip_after)
        self.cooldown_s = float(cooldown_s)
        # leaf lock: never held while taking any other framework lock
        self._lock = threading.Lock()
        self._breakers: dict = {}  # guarded-by: self._lock

    def configure(self, trip_after: Optional[int] = None,
                  cooldown_s: Optional[float] = None) -> None:
        """Adjust breaker policy for breakers created from now on (tests
        use tiny cooldowns; existing breakers keep their policy)."""
        with self._lock:
            if trip_after is not None:
                self.trip_after = int(trip_after)
            if cooldown_s is not None:
                self.cooldown_s = float(cooldown_s)

    def reset(self) -> None:
        """Drop all breaker state (fresh ladder; tests)."""
        with self._lock:
            self._breakers.clear()

    def _breaker(self, site: str, tier: str) -> Breaker:
        # caller holds self._lock (private helper of the locked regions)
        b = self._breakers.get((site, tier))
        if b is None:
            b = self._breakers[(site, tier)] = Breaker(
                self.trip_after, self.cooldown_s
            )
        return b

    def breaker_state(self, site: str, tier: str) -> str:
        with self._lock:
            b = self._breakers.get((site, tier))
            return b.state if b is not None else CLOSED

    def states(self) -> dict:
        """Point-in-time ``{"site/tier": state}`` over every breaker that
        has seen traffic."""
        with self._lock:
            return {
                f"{site}/{tier}": b.state
                for (site, tier), b in sorted(self._breakers.items())
            }

    def open_ages(self, now: Optional[float] = None) -> dict:
        """``{"site/tier": seconds-since-the-episode-opened}`` for every
        breaker currently OPEN (half-open probes in flight count as open —
        the tier is still not absorbing traffic). Ages are measured from
        the EPISODE start (``first_opened_at``), not the last re-trip:
        under steady traffic a stuck tier fails one half-open probe per
        cooldown, each re-trip moving ``opened_at`` — measured from there
        the age could never exceed one cooldown. ``now`` is injectable
        monotonic time for fake-clock tests."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            return {
                f"{site}/{tier}": max(
                    0.0, now - (b.first_opened_at or b.opened_at)
                )
                for (site, tier), b in sorted(self._breakers.items())
                if b.state in (OPEN, HALF_OPEN)
            }

    # -- recording helpers (metrics OUTSIDE the health lock) ---------------

    def _transition(self, site: str, tier: str, state: Optional[str]) -> None:
        if state is not None:
            _BREAKER_TOTAL.inc(1, (site, tier, state))
            _timeline.instant(
                "ladder.breaker", "robust", site=site, tier=tier, state=state
            )
            _decisions.record_decision(
                "ladder.breaker", state, site=site, tier=tier
            )

    def note_degrade(self, site: str, frm: str, to: str,
                     exc: Optional[BaseException] = None,
                     wasted_s: Optional[float] = None) -> None:
        """Record one degradation edge (also the public hook for a chain
        that keeps its own mechanics, e.g. the pack cache's spill to an
        uncached pack). ``wasted_s`` is the wall clock the failing tier
        burned before the degrade — a measured counterfactual, joined
        straight into the outcome ledger as pure regret: wall lost to a
        verdict that started on a tier which then failed."""
        _DEGRADE_TOTAL.inc(1, (site, frm, to))
        _timeline.instant(
            "ladder.degrade", "robust", site=site,
            frm=frm, to=to, error=type(exc).__name__ if exc else None,
        )
        inputs = {"site": site, "error": type(exc).__name__ if exc else None}
        if wasted_s is not None:  # breaker-skips burn no wall: no null key
            inputs["wasted_ms"] = round(wasted_s * 1e3, 3)
        seq = _decisions.record_decision(
            "ladder.degrade", f"{frm}->{to}", outcome=wasted_s is not None,
            **inputs,
        )
        if wasted_s is not None and seq is not None:
            from ..observe import outcomes as _outcomes

            _outcomes.resolve(
                seq, "ladder.degrade", wasted_s, engine=frm,
                regret_s=wasted_s,
            )

    def record_failure(self, site: str, tier: str) -> None:
        now = time.monotonic()
        with self._lock:
            t = self._breaker(site, tier).failure(now)
        self._transition(site, tier, t)

    def _probe_abort(self, site: str, tier: str) -> None:
        """Release an in-flight half-open probe without judging the tier —
        a FATAL error re-raises out of run() and must not wedge the
        breaker in a forever-denying probing state."""
        with self._lock:
            self._breaker(site, tier).probing = False

    def record_success(self, site: str, tier: str) -> None:
        with self._lock:
            t = self._breaker(site, tier).success()
        self._transition(site, tier, t)

    # -- the router --------------------------------------------------------

    def run(self, site: str, tiers: Sequence[Tuple[str, Callable[[], object]]],
            outcome_seq: Optional[int] = None,
            outcome_site: Optional[str] = None):
        """Execute ``tiers`` (ordered fastest→cheapest) through the health
        machinery; returns the first success. Every tier must compute the
        same result — degradation is a latency decision, never a
        correctness one. A ``"device"`` tier must be the last of the list:
        a device failure raises to the caller.

        ``outcome_seq`` is the dispatch decision's serial: the
        ladder times every attempt, resolves the decision with the tier
        that actually absorbed the traffic and its measured wall clock,
        and threads the serial into the per-attempt recorder span
        (``ladder.attempt``) so the decision–outcome join works both live
        and from a dumped trace. ``outcome_site`` is the DECISION's site
        (e.g. ``"agg.dispatch"`` for ladder site ``"agg"``) — it labels
        the orphan counter when the pending entry already aged out, so
        per-site join-vs-orphan series reconcile. Failed attempts feed
        their burned wall into the degrade edge as measured regret
        (``note_degrade``)."""
        if not tiers:
            raise ValueError(f"ladder site {site!r} has no tiers")
        if any(tier == "device" for tier, _ in tiers[:-1]):
            raise ValueError(
                f"ladder site {site!r}: the device tier must be the last of its list"
            )
        last = len(tiers) - 1
        now = time.monotonic()
        for i, (tier, fn) in enumerate(tiers):
            with self._lock:
                admit, trans = self._breaker(site, tier).allow(now)
            self._transition(site, tier, trans)
            if not admit and i < last:
                # open breaker: ride the next tier down without attempting
                self.note_degrade(site, tier, tiers[i + 1][0])
                continue
            t0 = time.perf_counter()
            try:
                with _timeline.tspan(
                    "ladder.attempt", "robust", site=site, tier=tier,
                    decision=outcome_seq,
                ):
                    val = fn()
            except Exception as e:
                attempt_s = time.perf_counter() - t0
                if classify(e) == FATAL:
                    self._probe_abort(site, tier)
                    raise
                self.record_failure(site, tier)
                if i == last:
                    raise  # nothing below the bottom rung
                self.note_degrade(
                    site, tier, tiers[i + 1][0], e, wasted_s=attempt_s
                )
                continue
            self.record_success(site, tier)
            if outcome_seq is not None:
                from ..observe import outcomes as _outcomes

                _outcomes.resolve(
                    outcome_seq, outcome_site or site,
                    time.perf_counter() - t0, engine=tier,
                )
            return val
        raise AssertionError("unreachable: bottom tier returns or raises")  # pragma: no cover


LADDER = Ladder()


# ---------------------------------------------------------------------------
# retry with jittered backoff (transient sites)
# ---------------------------------------------------------------------------


def _jitter(site: str, attempt: int, base_s: float, cap_s: float) -> float:
    """Bounded exponential backoff with deterministic decorrelated jitter:
    delay in [base·2^(a-1)/2, base·2^(a-1)], capped. Deterministic (a pure
    function of site+attempt) so schedule replays sleep identically."""
    exp = min(cap_s, base_s * (1 << max(0, attempt - 1)))
    h = zlib.crc32(f"retry:{site}:{attempt}".encode())
    frac = 0.5 + 0.5 * ((h & 0xFFFF) / float(1 << 16))
    return exp * frac


def retry(site: str, fn: Callable[[], object], *, attempts: int = 3,
          base_s: float = 0.01, cap_s: float = 0.25):
    """Run ``fn``, retrying transient-classified failures with jittered
    backoff. Non-transient failures raise immediately (a resource
    exhaustion will not un-exhaust on the same tier). Deadline-aware: when
    the ambient deadline budget cannot absorb the next backoff, the last
    error raises now instead of sleeping the caller past its budget."""
    a = 0
    while True:
        a += 1
        try:
            val = fn()
        except Exception as e:
            if classify(e) != TRANSIENT:
                _RETRY_TOTAL.inc(1, (site, "not_retryable"))
                raise
            if a >= attempts:
                _RETRY_TOTAL.inc(1, (site, "exhausted"))
                raise
            delay = _jitter(site, a, base_s, cap_s)
            rem = deadline_remaining()
            if rem is not None and delay >= rem:
                _RETRY_TOTAL.inc(1, (site, "exhausted"))
                raise
            _RETRY_TOTAL.inc(1, (site, "retried"))
            _timeline.instant(
                "ladder.retry", "robust", site=site, attempt=a,
                delay_ms=round(delay * 1e3, 3),
            )
            time.sleep(delay)
            continue
        if a > 1:
            _RETRY_TOTAL.inc(1, (site, "recovered"))
        return val


# ---------------------------------------------------------------------------
# per-query deadline budgets
# ---------------------------------------------------------------------------

_TLS = threading.local()  # .deadline: monotonic deadline stack


class deadline_scope:
    """Arm a wall-clock budget for the enclosed work on this thread.
    Nested scopes keep the TIGHTER deadline (a sub-query cannot outlive
    its parent's budget)."""

    def __init__(self, seconds: Optional[float]):
        self._seconds = seconds
        self._token = None

    def __enter__(self) -> "deadline_scope":
        stack = getattr(_TLS, "deadline", None)
        if stack is None:
            stack = _TLS.deadline = []
        if self._seconds is None:
            dl = stack[-1] if stack else None
        else:
            dl = time.monotonic() + float(self._seconds)
            if stack and stack[-1] is not None:
                dl = min(dl, stack[-1])
        stack.append(dl)
        return self

    def __exit__(self, *exc) -> None:
        _TLS.deadline.pop()


def deadline_remaining() -> Optional[float]:
    """Seconds left in the ambient budget; None when no scope is armed."""
    stack = getattr(_TLS, "deadline", None)
    if not stack or stack[-1] is None:
        return None
    return stack[-1] - time.monotonic()


def deadline_expired() -> bool:
    rem = deadline_remaining()
    return rem is not None and rem <= 0


def note_deadline(site: str, outcome: str) -> None:
    _DEADLINE_TOTAL.inc(1, (site, outcome))
    if outcome != "met":
        _timeline.instant("ladder.deadline", "robust", site=site, outcome=outcome)
