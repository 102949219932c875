"""Priced admission control: per-tenant token-bucket quotas + a global
in-flight cap with shed-or-queue backpressure.

Counterpart of ``roaringbitmap_tpu/serve/admission.py``, with the same
verdicts, decision site, metrics and fault site. Every request entering
the serving tier passes one :meth:`AdmissionController.admit` call, which
yields one of three verdicts:

* ``admit`` — the tenant's token bucket has budget and a global
  in-flight slot is free: the request proceeds immediately;
* ``queue`` — the tenant has quota budget but the global in-flight cap
  (``RB_TPU_SERVE_INFLIGHT``, default twice the CPU count) is full and
  the backpressure queue has room: the caller blocks until a slot frees,
  or its wait budget expires, which turns the verdict into a shed with
  the token refunded. An interactive tenant's wait is clamped to its
  declared p99 budget. Quota exhaustion never queues: an empty bucket
  sheds at once;
* ``shed`` — quota exhausted, the queue full, or the wait budget
  expired: the request is rejected with a typed :class:`ShedRejection`,
  never a wrong answer.

**Priced verdicts** (``cost/admission.py``): every admit / queue verdict
records a ``serve.admit`` decision with the predicted admission wall
(``est_us[verdict]``) and resolves it with the measured wall on grant, so
the outcome ledger scores the admission curve like every other pricing
authority. Shed verdicts are decision-logged, not joined.

**Fault site** ``serve.admit``: an injected or real non-fatal failure in
the verdict path fails OPEN — the request is admitted with the degrade
noted — because admission is load management, never a correctness gate.
This is the JAX package's semantics, not a device fallback: nothing on
the card is skipped, and the request then runs its device path or raises
like any other.

Lock discipline: the controller's condition lock is a leaf; decision
records, outcome joins, metric bumps and the fault point run outside it.

Determinism: the clock is injectable (``clock=`` at construction and
``now=`` per call), so quota arithmetic replays exactly under a fake
clock.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

from ..observe import decisions as _decisions
from ..observe import outcomes as _outcomes
from ..observe import registry as _registry
from ..observe import timeline as _timeline
from ..robust import errors as _rerrors
from ..robust import faults as _faults
from ..robust import ladder as _ladder
from ..cost import admission as _admission_cost
from . import slo as _slo
from .slo import TENANTS

DEFAULT_QUEUE_LIMIT = 64
DEFAULT_QUEUE_TIMEOUT_S = 5.0

VERDICTS = ("admit", "queue", "shed")

_ADMIT_TOTAL = _registry.counter(
    _registry.SERVE_ADMIT_TOTAL,
    "Admission verdicts by tenant (admit | queue | shed); queue counts "
    "requests that waited in the backpressure queue before a grant",
    ("tenant", "verdict"),
)
_QUEUE_COUNT = _registry.gauge(
    _registry.SERVE_QUEUE_COUNT,
    "Requests currently parked in the admission backpressure queue",
)
_INFLIGHT_COUNT = _registry.gauge(
    _registry.SERVE_INFLIGHT_COUNT,
    "Requests currently holding a global in-flight slot",
)
_SATURATION = _registry.gauge(
    _registry.SERVE_SATURATION_RATIO,
    "Per-tenant token-bucket depletion (0 = full quota budget available, "
    "1 = quota exhausted — the tenant-saturation sentinel rule's gauge)",
    ("tenant",),
)


class ShedRejection(Exception):
    """Typed admission rejection: the request was NOT served (quota
    exhausted / queue full / wait budget expired). Carries the tenant
    and the reason so callers can retry, downgrade, or surface a 429 —
    never mistakable for a result."""

    def __init__(self, tenant: str, reason: str):
        super().__init__(f"request shed for tenant {tenant!r}: {reason}")
        self.tenant = tenant
        self.reason = reason


class _Bucket:
    """Per-tenant token bucket (pure arithmetic; the controller's lock
    owns all mutation)."""

    __slots__ = ("rate", "burst", "tokens", "stamp")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.stamp = float(now)

    def refill(self, now: float) -> None:
        # the stamp only ever advances: admit() reads the clock OUTSIDE
        # the controller lock, so a racing older `now` must not rewind
        # the stamp and re-credit an already-credited interval
        if now > self.stamp:
            self.tokens = min(self.burst, self.tokens + (now - self.stamp) * self.rate)
            self.stamp = now

    def take(self) -> bool:
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False

    def saturation(self) -> float:
        return round(1.0 - self.tokens / self.burst, 4)


class Ticket:
    """One admission grant (or rejection). ``verdict`` is the recorded
    decision; ``admitted`` is whether the caller may proceed. Use as a
    context manager so the in-flight slot always releases."""

    __slots__ = ("controller", "tenant", "verdict", "admitted", "queue_s", "degraded")

    def __init__(self, controller, tenant, verdict, admitted, queue_s, degraded=False):
        self.controller = controller
        self.tenant = tenant
        self.verdict = verdict
        self.admitted = admitted
        self.queue_s = queue_s
        self.degraded = degraded

    def release(self) -> None:
        if self.admitted:
            self.controller._release()
            self.admitted = False

    def __enter__(self) -> "Ticket":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def _default_inflight() -> int:
    raw = os.environ.get("RB_TPU_SERVE_INFLIGHT")
    try:
        if raw:
            return max(1, int(raw))
    except ValueError:
        pass
    return 2 * (os.cpu_count() or 1)


class AdmissionController:
    """Token-bucket quotas (from the declared tenant registry) + a global
    in-flight cap with a bounded backpressure queue."""

    def __init__(
        self,
        max_inflight: Optional[int] = None,
        queue_limit: int = DEFAULT_QUEUE_LIMIT,
        queue_timeout_s: float = DEFAULT_QUEUE_TIMEOUT_S,
        clock=time.monotonic,
    ):
        self.max_inflight = (
            int(max_inflight) if max_inflight is not None else _default_inflight()
        )
        if self.max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {self.max_inflight}")
        self.queue_limit = max(0, int(queue_limit))
        self.queue_timeout_s = float(queue_timeout_s)
        # the PROCESS tenant registry, deliberately not injectable: every
        # metric label value below is the lint-enforced TENANTS[tenant]
        # spelling, so a controller over a foreign registry would take an
        # in-flight slot and then KeyError on the label lookup
        self.tenants = TENANTS
        self._clock = clock
        self._cond = threading.Condition()  # leaf: guards the fields below only
        self._buckets: Dict[str, _Bucket] = {}  # guarded-by: self._cond
        self._inflight = 0  # guarded-by: self._cond
        self._queued = 0  # guarded-by: self._cond

    # -- internals (all called with self._cond held) ------------------------

    def _bucket(self, tenant: str, now: float, quota: dict) -> _Bucket:
        # quota is prefetched by admit() OUTSIDE this lock: reading the
        # tenant registry here would nest its leaf lock under ours and
        # break the leaf claim the witness hammer pins
        b = self._buckets.get(tenant)
        if b is None:
            b = self._buckets[tenant] = _Bucket(quota["quota_qps"], quota["burst"], now)
        elif b.rate != quota["quota_qps"] or b.burst != quota["burst"]:
            # the registry documents declare() as idempotent-with-update:
            # a live quota change must reach the cached bucket, or the
            # tenant keeps being shed at the old rate until a reset()
            b.rate = quota["quota_qps"]
            b.burst = quota["burst"]
            b.tokens = min(b.tokens, b.burst)
        b.refill(now)
        return b

    def _release(self) -> None:
        with self._cond:
            self._inflight -= 1
            inflight = self._inflight
            # notify_all, not notify: a single wake can land on a waiter
            # that already timed out (it stays in the waiter list until
            # it reacquires the lock), parking the freed slot while live
            # waiters sleep out their full budget
            self._cond.notify_all()
        _INFLIGHT_COUNT.set(inflight)

    # -- the verdict ---------------------------------------------------------

    def admit(
        self,
        tenant: str,
        now: Optional[float] = None,
        wait: bool = True,
        epoch: Optional[int] = None,
    ) -> Ticket:
        """One admission verdict for ``tenant`` (must be declared in the
        tenant registry). ``now`` pins the quota clock (fake-clock
        determinism); ``wait=False`` makes a queue verdict return
        immediately un-admitted instead of blocking (the determinism
        tests' non-blocking form); ``epoch`` stamps the serving epoch the
        request was admitted under into the decision inputs (the outcome
        ledger then decomposes admission joins by epoch).
        Returns a :class:`Ticket`; a shed verdict's ticket has
        ``admitted=False`` — callers that cannot degrade raise
        :class:`ShedRejection` via :meth:`admit_or_raise`."""
        canon = self.tenants[tenant]
        extra = {} if epoch is None else {"epoch": int(epoch)}
        try:
            _faults.fault_point("serve.admit")
        except Exception as e:
            if _rerrors.classify(e) == _rerrors.FATAL:
                raise
            # fail OPEN: admission is load management, not correctness —
            # a broken quota path must degrade to "serve everything",
            # never to dropping or corrupting requests
            _ladder.LADDER.note_degrade("serve.admit", "quota", "fail-open", e)
            with self._cond:
                self._inflight += 1
                inflight = self._inflight
            _INFLIGHT_COUNT.set(inflight)
            _ADMIT_TOTAL.inc(1, (TENANTS[tenant], "admit"))
            _decisions.record_decision(
                "serve.admit", "admit", tenant=canon, degraded=True, **extra,
            )
            return Ticket(self, canon, "admit", True, 0.0, degraded=True)
        t0 = time.perf_counter()
        if now is None:
            now = self._clock()
        quota = self.tenants.quota(canon)  # registry leaf lock, pre-cond
        with self._cond:
            b = self._bucket(canon, now, quota)
            has_token = b.take()
            saturation = b.saturation()
            depth = self._queued
            if has_token and self._inflight < self.max_inflight:
                verdict = "admit"
                self._inflight += 1
            elif has_token and depth < self.queue_limit:
                verdict = "queue"
                self._queued += 1
            else:
                verdict = "shed"
                if has_token:  # capacity shed, not quota: refund the token
                    b.tokens = min(b.burst, b.tokens + 1.0)
                    saturation = b.saturation()
            inflight, queued = self._inflight, self._queued
        # telemetry + decision outside the leaf lock
        _INFLIGHT_COUNT.set(inflight)
        _QUEUE_COUNT.set(queued)
        _SATURATION.set(saturation, (TENANTS[tenant],))
        # verdict counters count each request ONCE, by FINAL outcome: a
        # queue verdict is counted only when it resolves below (grant ->
        # "queue", timeout -> "shed") — double-counting would dilute the
        # tenant-saturation rule's shed fraction to <= 0.5 during a
        # complete timeout-driven outage
        if verdict != "queue":
            _ADMIT_TOTAL.inc(1, (TENANTS[tenant], str(verdict)))
        if verdict == "shed":
            _decisions.record_decision(
                "serve.admit", "shed", tenant=canon, depth=depth,
                inflight=inflight, saturation=saturation, **extra,
            )
            _timeline.instant(
                "serve.shed", "serve", tenant=canon, depth=depth,
            )
            return Ticket(self, canon, "shed", False, 0.0)
        predicted = _admission_cost.MODEL.predict_us(verdict, depth)
        seq = _decisions.record_decision(
            "serve.admit", verdict, outcome=_outcomes.enabled(),
            est_us={verdict: predicted}, tenant=canon, depth=depth,
            inflight=inflight, saturation=saturation, **extra,
        )
        if verdict == "admit":
            _outcomes.resolve(
                seq, "serve.admit", time.perf_counter() - t0, engine="admit",
            )
            return Ticket(self, canon, "admit", True, 0.0)
        # queue verdict: wait for an in-flight slot (bounded). An
        # interactive tenant's wait is additionally clamped to its
        # declared p99 budget: queueing past the whole SLO
        # just delivers a guaranteed breach — shedding at the budget
        # lets the caller retry or degrade while the answer could still
        # matter. Other classes keep the plain capacity timeout.
        wait_budget_s = self.queue_timeout_s
        if quota.get("latency_class") == "interactive":
            budget_ms = quota.get("p99_budget_ms")
            if budget_ms:
                wait_budget_s = min(wait_budget_s, float(budget_ms) / 1e3)
        granted = False
        if wait:
            deadline = time.perf_counter() + wait_budget_s
            with self._cond:
                while True:
                    if self._inflight < self.max_inflight:
                        self._inflight += 1
                        granted = True
                        break
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
                self._queued -= 1
                inflight, queued = self._inflight, self._queued
            _INFLIGHT_COUNT.set(inflight)
            _QUEUE_COUNT.set(queued)
        else:
            with self._cond:
                self._queued -= 1
                queued = self._queued
                # nothing was served: refund the token (the capacity-shed
                # discipline — quota must only be spent on served work)
                b.tokens = min(b.burst, b.tokens + 1.0)
            _QUEUE_COUNT.set(queued)
            # non-blocking form: the verdict IS queue (would-block); the
            # caller declined the wait, so there is no timeout shed here
            _ADMIT_TOTAL.inc(1, (TENANTS[tenant], "queue"))
            _outcomes.resolve(
                seq, "serve.admit", time.perf_counter() - t0, engine="queue",
            )
            return Ticket(self, canon, "queue", False, 0.0)
        queue_s = time.perf_counter() - t0
        # the queue verdict's measured join: predicted backpressure wait
        # vs the wall the request actually waited (granted or not — the
        # wait happened either way and the curve is scored on it)
        _outcomes.resolve(seq, "serve.admit", queue_s, engine="queue")
        if granted:
            _ADMIT_TOTAL.inc(1, (TENANTS[tenant], "queue"))
            return Ticket(self, canon, "queue", True, queue_s)
        with self._cond:
            # timed out un-served: refund the token (see the non-blocking
            # branch above — quota is only spent on served work)
            b.tokens = min(b.burst, b.tokens + 1.0)
        _ADMIT_TOTAL.inc(1, (TENANTS[tenant], "shed"))
        _timeline.instant(
            "serve.shed", "serve", tenant=canon, reason="queue-timeout",
        )
        return Ticket(self, canon, "shed", False, queue_s)

    def admit_or_raise(self, tenant: str, now: Optional[float] = None) -> Ticket:
        t = self.admit(tenant, now=now)
        if not t.admitted:
            raise ShedRejection(t.tenant, "queue-timeout" if t.queue_s else "quota")
        return t

    # -- read APIs -----------------------------------------------------------

    def stats(self) -> dict:
        with self._cond:
            return {
                "max_inflight": self.max_inflight,
                "inflight": self._inflight,
                "queued": self._queued,
                "queue_limit": self.queue_limit,
                "saturation": {
                    t: b.saturation() for t, b in sorted(self._buckets.items())
                },
            }

    def reset(self) -> None:
        """Drop bucket state (tests, benchmark windows); quotas re-read from
        the tenant registry on next admit."""
        with self._cond:
            self._buckets.clear()
            self._inflight = 0
            self._queued = 0
            self._cond.notify_all()
        _INFLIGHT_COUNT.set(0)
        _QUEUE_COUNT.set(0)


# The process-wide controller the harness drives.
CONTROLLER = AdmissionController()
