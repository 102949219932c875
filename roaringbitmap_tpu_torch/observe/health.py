"""Declarative health rules over the telemetry surface.

Counterpart of ``roaringbitmap_tpu/observe/health.py``, with the same rule
names, bands, hysteresis and enum-gauge encoding. The signals (drift
gauges, breaker states, regret rollups, anomaly counters, the accounting
reconciliation) each describe one subsystem; this module is the judgement
layer: a **rule table** evaluated over point-in-time snapshots of those
registries, folding into one process status.

* :class:`Rule` — a named probe over a :class:`Snapshot` returning a
  scalar "badness" (bigger is worse), with **warn/critical bands**
  (``value >= warn`` → WARN, ``>= critical`` → CRITICAL), **hysteresis**
  (``fire_after`` consecutive out-of-band ticks to raise the level,
  ``clear_after`` consecutive in-band ticks to lower it — a single noisy
  sample never flips the status), and **flap suppression** (a rule whose
  raw band changed ``flap_limit`` times within the last ``flap_window``
  ticks is *flapping*: it holds its fired level and suppresses downward
  transitions until the signal stabilises — an oscillating input produces
  one alert, not an alert storm).
* :class:`RuleState` — the per-rule evaluation state machine. Pure data +
  arithmetic: no clocks, no locks, no I/O — the sentinel owns locking and
  pacing, which is what makes the fake-clock tests deterministic.
* :class:`Snapshot` — what probes see: the metrics-registry snapshot,
  breaker open-ages, the cost-model drift cells, and the outcome ledger's
  per-site rollup, plus ``counter_delta`` (per-tick counter movement
  against the previous tick's totals — rate rules without a clock).

Levels are the Prometheus-style enum-gauge encoding the new metrics
export: per-rule ``rb_tpu_health_rule_state{rule}`` ∈ {0 ok, 1 warn,
2 critical} and the process rollup ``rb_tpu_health_status`` ∈ {0 green,
1 yellow, 2 red} = max over rules.

The **default rule table** below is the JAX package's, rule for rule:

====================== ======================================== ===== =====
rule                   badness value                            warn  crit
====================== ======================================== ===== =====
costmodel-drift        max over drift cells of max(r, 1/r)      2.0   4.0
routing-regret         cumulative regret_s / measured_s         0.05  0.20
breaker-stuck-open     max seconds any breaker has been open    30    300
outcome-anomaly-burst  out-of-band joins since last tick        1     16
hbm-accounting-drift   max |accounting drift| bytes             1     2^20
compile-storm          jit traces since last tick               8     32
fusion-queue-stall     fusion queue depth with no drained batch 1     64
serving-p99-breach     worst per-tenant windowed serving p99 s  0.5   2.0
tenant-saturation      worst per-tenant shed fraction per tick  0.25  0.75
freshness-lag-breach   worst windowed ingest->queryable p99 s   2.0   10.0
epoch-flip-stall       mutation-log depth with no epoch flip    4     64
structure-drift        actual/optimal serialized-bytes ratio    1.3   2.0
delta-accretion        epoch-delta batches since maintenance    8     64
epoch-persist-stall    persist backlog with no completed persist 4    64
recovery-manifest-torn torn artifacts skipped by recovery       0.5   1
serving-p99-pressure   worst tenant p99 / declared p99 budget   1.0   2.0
====================== ======================================== ===== =====

Actuations (the sentinel's closed-loop half — see ``observe.sentinel``):
``costmodel-drift`` actuates ``"refit"`` (the ``cost/`` facade's
``refit_all``); ``structure-drift`` and ``delta-accretion`` actuate
``"maintain"`` (a priced maintenance pass, ``serve/maintain.py``);
``serving-p99-pressure`` actuates ``"autotune"`` (the fusion window's
``autotune_window``); the rest actuate ``"alert"`` (a structured instant
and decision entry on the fire transition); any rule reaching CRITICAL
also triggers a one-shot flight bundle (``observe.bundle``).

The rules over serving, epoch and durable metrics read the series that
``serve/`` (``slo``, ``admission``, ``ingest``, ``epochs``, ``maintain``)
and ``durable/`` register.

**The one departure is ``hbm-accounting-drift``.** The JAX rule judges
``max |drift|`` over every source. Its ``device`` source is the resident
gauge minus the device's allocated bytes, which the JAX package's own
reconciliation expects to be negative (the device holds payloads,
scratch and results beside the pack cache) and calls only a positive
drift the red flag; on the CPU client the JAX package never has that
source. On a card the allocator always counts more than the resident
packs, so |drift| would read hundreds of MB and go red on every tick.
The port judges the ``ledger`` source by its magnitude and the ``device``
source by its positive part only (ROADMAP, departures).
"""

from __future__ import annotations

from dataclasses import dataclass
from collections import deque
from typing import Callable, Dict, Optional, Tuple

from . import registry as _registry

OK, WARN, CRITICAL = 0, 1, 2
LEVEL_NAMES = {OK: "ok", WARN: "warn", CRITICAL: "critical"}
STATUS_NAMES = {OK: "green", WARN: "yellow", CRITICAL: "red"}

# enum gauges (see module docstring for the encoding); registered here so
# the series exist for the export/health-block derivation even before the
# first sentinel tick
HEALTH_STATUS = _registry.gauge(
    _registry.HEALTH_STATUS,
    "Process health rollup from the sentinel rule table "
    "(0 green / 1 yellow / 2 red = max over rule states)",
)
HEALTH_RULE_STATE = _registry.gauge(
    _registry.HEALTH_RULE_STATE,
    "Per-rule health level after hysteresis/flap suppression "
    "(0 ok / 1 warn / 2 critical)",
    ("rule",),
)


@dataclass(frozen=True)
class Rule:
    """One declarative health judgement. ``probe(snapshot)`` returns the
    scalar badness (bigger is worse; None = no data, treated as OK);
    ``actuation`` names the closed-loop response the sentinel runs when
    the rule fires (``"refit"`` / ``"alert"`` / None)."""

    name: str
    help: str
    probe: Callable[["Snapshot"], Optional[float]]
    warn: float
    critical: float
    fire_after: int = 2
    clear_after: int = 2
    flap_window: int = 16
    flap_limit: int = 4
    actuation: Optional[str] = None

    def band(self, value: Optional[float]) -> int:
        """The raw (pre-hysteresis) level of one sample."""
        if value is None:
            return OK
        if value >= self.critical:
            return CRITICAL
        if value >= self.warn:
            return WARN
        return OK


class RuleState:
    """The per-rule hysteresis + flap-suppression state machine. Owned
    and locked by the sentinel; this class itself is pure bookkeeping so
    tests drive it tick-by-tick with no clock at all."""

    __slots__ = (
        "level", "streak_worse", "streak_better", "last_raw", "last_value",
        "flapping", "_band_changes", "history",
    )

    def __init__(self, history: int = 64):
        self.level = OK
        self.streak_worse = 0
        self.streak_better = 0
        self.last_raw: Optional[int] = None
        self.last_value: Optional[float] = None
        self.flapping = False
        # tick numbers at which the RAW band changed (the flap signal —
        # counting applied transitions would self-sustain: a suppressed
        # clear would count as instability and pin the rule flapping)
        self._band_changes: "deque[int]" = deque()
        self.history: "deque[dict]" = deque(maxlen=history)

    def step(self, rule: Rule, value: Optional[float], tick_no: int) -> dict:
        """Advance one tick; returns the evaluation record (also appended
        to ``history``): value, raw band, applied level, the transition
        (``(from, to)`` or None), and whether flap suppression held a
        would-be clear."""
        raw = rule.band(value)
        # flap bookkeeping first: raw band movement within the window
        if self.last_raw is not None and raw != self.last_raw:
            self._band_changes.append(tick_no)
        self.last_raw = raw
        self.last_value = value
        floor = tick_no - rule.flap_window
        while self._band_changes and self._band_changes[0] <= floor:
            self._band_changes.popleft()
        self.flapping = len(self._band_changes) >= rule.flap_limit
        transition: Optional[Tuple[int, int]] = None
        suppressed = False
        if raw > self.level:
            self.streak_worse += 1
            self.streak_better = 0
            if self.streak_worse >= rule.fire_after:
                transition = (self.level, raw)
                self.level = raw
                self.streak_worse = 0
        elif raw < self.level:
            self.streak_better += 1
            self.streak_worse = 0
            if self.streak_better >= rule.clear_after:
                if self.flapping:
                    # hold the fired level: an oscillating signal must not
                    # clear-and-refire its way into an alert storm
                    suppressed = True
                else:
                    transition = (self.level, raw)
                    self.level = raw
                self.streak_better = 0
        else:
            self.streak_worse = 0
            self.streak_better = 0
        rec = {
            "tick": tick_no,
            "value": value,
            "raw": raw,
            "level": self.level,
            "transition": transition,
            "flapping": self.flapping,
            "suppressed": suppressed,
        }
        self.history.append(rec)
        return rec

    def as_dict(self) -> dict:
        return {
            "level": self.level,
            "level_name": LEVEL_NAMES[self.level],
            "value": self.last_value,
            "flapping": self.flapping,
        }


# ---------------------------------------------------------------------------
# snapshot: what rule probes see
# ---------------------------------------------------------------------------


class Snapshot:
    """Point-in-time view of every registry a rule may judge. Built by
    ``snapshot()`` OUTSIDE the sentinel lock (gathering takes the
    registry/ladder/ledger leaf locks); probes then run against plain
    data. ``counter_delta`` compares against the previous tick's totals
    (``prev_sums``) — the first tick reports 0 so pre-existing totals
    never fire a rate rule."""

    def __init__(
        self,
        metrics: dict,
        breaker_open_ages: Dict[str, float],
        drift: Dict[Tuple[str, str, str], float],
        outcome_sites: Dict[str, dict],
        now: float,
        prev_sums: Optional[Dict[str, float]] = None,
    ):
        self.metrics = metrics
        self.breaker_open_ages = breaker_open_ages
        self.drift = drift
        self.outcome_sites = outcome_sites
        self.now = now
        self._prev = prev_sums or {}
        self.sums: Dict[str, float] = {}  # totals touched this tick

    def counter_sum(self, name: str) -> float:
        m = self.metrics.get(name)
        if m is None:
            return 0.0
        return float(sum(s.get("value", 0) for s in m.get("samples", ())))

    def counter_delta(self, name: str) -> float:
        cur = self.counter_sum(name)
        self.sums[name] = cur
        prev = self._prev.get(name)
        if prev is None:
            return 0.0
        return max(0.0, cur - prev)

    def labeled_counter_delta(self, name: str) -> Dict[Tuple[str, ...], float]:
        """Per-series counter movement since the previous tick (compound
        ``name|labelvalues`` keys ride the same prev-sums channel as
        :meth:`counter_delta`; a series first seen this tick reports 0 so
        pre-existing totals never fire a rate rule)."""
        m = self.metrics.get(name)
        out: Dict[Tuple[str, ...], float] = {}
        if m is None:
            return out
        labelnames = m.get("labelnames", [])
        for s in m.get("samples", ()):
            lv = tuple(s["labels"].get(n, "") for n in labelnames)
            key = name + "|" + "|".join(lv)
            cur = float(s.get("value", 0))
            self.sums[key] = cur
            prev = self._prev.get(key)
            out[lv] = 0.0 if prev is None else max(0.0, cur - prev)
        return out

    def histogram_delta_quantile(self, name: str, q: float) -> Optional[float]:
        """Windowed quantile over a histogram's per-tick movement —
        the max over series, or None when no series moved (first tick,
        idle window). See :meth:`histogram_delta_quantiles`."""
        per = self.histogram_delta_quantiles(name, q)
        return max(per.values()) if per else None

    def histogram_delta_quantiles(
        self, name: str, q: float
    ) -> Dict[Tuple[str, ...], float]:
        """Per-series windowed quantile over a histogram's per-tick
        movement: for each labeled series, rebuild the bucket counts
        observed SINCE the previous tick (cumulative-``le`` diffs against
        the prev-sums channel) and estimate the ``q``-quantile by the
        same cumulative-walk + in-bucket interpolation as
        LatencyHistogram; a series that did not move this tick (first
        tick, idle window) is omitted — cumulative histograms would
        otherwise pin a breach forever after one bad burst. The sums
        writes are idempotent, so probes may call this and
        :meth:`histogram_delta_quantile` on the same name in one tick."""
        out: Dict[Tuple[str, ...], float] = {}
        m = self.metrics.get(name)
        if m is None:
            return out
        for s in m.get("samples", ()):
            lv = [s["labels"][n] for n in m.get("labelnames", [])]
            skey = name + "|" + "|".join(lv)
            buckets = s.get("buckets") or {}
            count = float(s.get("count", 0))
            cur = {le: float(c) for le, c in buckets.items()}
            first = (skey + "|count") not in self._prev
            prev_count = self._prev.get(skey + "|count", 0.0)
            self.sums[skey + "|count"] = count
            for le, c in cur.items():
                self.sums[skey + "|" + le] = c
            if first:
                continue
            total = count - prev_count
            if total <= 0:
                continue
            keyed = sorted(
                ((le, float(le)) for le in cur if le != "+Inf"),
                key=lambda kv: kv[1],
            )
            bounds = [b for _le, b in keyed]
            slots = []
            prev_cum = 0.0
            for le, _b in keyed:
                cum = cur[le] - self._prev.get(skey + "|" + le, 0.0)
                slots.append(max(0.0, cum - prev_cum))
                prev_cum = max(prev_cum, cum)
            slots.append(max(0.0, total - prev_cum))  # +Inf overflow
            rank = max(1.0, q * total)
            cum = 0.0
            est = bounds[-1] if bounds else 0.0
            for i, n in enumerate(slots):
                if n <= 0:
                    continue
                below = cum
                cum += n
                if cum >= rank:
                    if i >= len(bounds):
                        est = bounds[-1]  # overflow: clamp
                    else:
                        hi = bounds[i]
                        lo = bounds[i - 1] if i > 0 else 0.0
                        est = lo + (hi - lo) * ((rank - below) / n)
                    break
            out[tuple(lv)] = est
        return out

    def gauge_max_abs(self, name: str) -> float:
        m = self.metrics.get(name)
        if m is None:
            return 0.0
        vals = [abs(s.get("value", 0)) for s in m.get("samples", ())]
        return float(max(vals)) if vals else 0.0


def snapshot(
    prev_sums: Optional[Dict[str, float]] = None,
    now: Optional[float] = None,
    refresh_hbm: bool = True,
) -> Snapshot:
    """Gather the rule-probe view. ``refresh_hbm`` additionally runs the
    device-memory reconciliation so the drift gauges judge current
    reality, not the last time someone happened to reconcile; any failure
    there leaves the stale gauges in place (judging stale telemetry beats
    killing the supervisor). The reconciliation reads the card only when
    CUDA is already initialized."""
    import time as _time

    from . import outcomes as _outcomes

    if refresh_hbm:
        try:
            from ..parallel import store as _store

            _store.hbm_reconciliation()
        except Exception:  # rb-ok: exception-hygiene -- the supervisor keeps judging on stale gauges when a refresh fails; the stale values are still real telemetry
            pass
    ages: Dict[str, float] = {}
    try:
        from ..robust import ladder as _ladder

        ages = _ladder.LADDER.open_ages()
    except Exception:  # rb-ok: exception-hygiene -- the same stale-beats-dead contract as the refresh above
        pass
    return Snapshot(
        metrics=_registry.REGISTRY.snapshot(),
        breaker_open_ages=ages,
        drift=_outcomes.LEDGER.drift(),
        outcome_sites=_outcomes.LEDGER.summary(),
        now=_time.monotonic() if now is None else now,
        prev_sums=prev_sums,
    )


# ---------------------------------------------------------------------------
# the committed default rule table
# ---------------------------------------------------------------------------


def _drift_badness(s: Snapshot) -> float:
    """Worst coefficient-cell drift, symmetric: max(r, 1/r) over the
    geometric-EWMA cells (1.0 = every calibrated curve still truthful)."""
    worst = 1.0
    for r in s.drift.values():
        if r > 0:
            worst = max(worst, r, 1.0 / r)
    return worst


def _regret_fraction(s: Snapshot) -> float:
    """Cumulative wall lost to wrong verdicts as a fraction of the joined
    measured wall (the ROADMAP item 4 gate, judged continuously)."""
    regret = sum(a.get("regret_s", 0.0) for a in s.outcome_sites.values())
    measured = sum(a.get("measured_s", 0.0) for a in s.outcome_sites.values())
    if measured <= 0:
        return 0.0
    return regret / measured


def _max_open_age(s: Snapshot) -> float:
    return max(s.breaker_open_ages.values(), default=0.0)


def _hbm_drift_badness(s: Snapshot) -> float:
    """Accounting drift in bytes: ``max |drift|`` over the ``ledger``
    source (any nonzero is an accounting bug) and the positive part of
    the ``device`` source (the resident packs claiming more than the
    allocator holds). A negative device drift — the card holding more
    than the pack cache — is the expected state and judges 0."""
    m = s.metrics.get(_registry.HBM_ACCOUNTING_DRIFT_BYTES)
    if m is None:
        return 0.0
    worst = 0.0
    for smp in m.get("samples", ()):
        v = float(smp.get("value", 0))
        if smp.get("labels", {}).get("source") == "device":
            v = max(0.0, v)
        worst = max(worst, abs(v))
    return worst


def _serving_p99_breach(s: Snapshot) -> Optional[float]:
    """Worst windowed p99 (seconds) over the serving tier's per-tenant
    latency series since the last tick. The
    window is the per-tick histogram movement, so a single bad burst
    clears once traffic recovers instead of pinning the cumulative p99
    red forever; queue-phase series count too — a breach driven by
    backpressure wait is exactly what an operator needs to see."""
    return s.histogram_delta_quantile(_registry.SERVE_LATENCY_SECONDS, 0.99)


# a tenant must offer at least this many requests in a tick window before
# its shed fraction is judged — one shed of one request is not saturation
_SATURATION_MIN_REQUESTS = 8.0


def _tenant_saturation(s: Snapshot) -> Optional[float]:
    """Worst per-tenant shed fraction since the last tick: sheds over
    offered admission verdicts, judged only for tenants with enough
    window volume. A tenant
    over quota sheds a sustained fraction of its traffic; transient
    single-request noise stays below the volume floor."""
    deltas = s.labeled_counter_delta(_registry.SERVE_ADMIT_TOTAL)
    per_tenant: Dict[str, Dict[str, float]] = {}
    for (tenant, verdict), d in deltas.items():
        per_tenant.setdefault(tenant, {})[verdict] = d
    worst: Optional[float] = None
    for tenant, by_verdict in per_tenant.items():
        offered = sum(by_verdict.values())
        if offered < _SATURATION_MIN_REQUESTS:
            continue
        frac = by_verdict.get("shed", 0.0) / offered
        worst = frac if worst is None else max(worst, frac)
    return worst


def _freshness_lag_breach(s: Snapshot) -> Optional[float]:
    """Worst windowed ingest->queryable lag p99 (seconds) over the epoch
    ledger's per-tenant freshness series since the last tick. Same per-tick windowing
    as the serving-p99 rule: a stale flip fires while stale batches keep
    publishing and clears once fresh flips resume — a cumulative p99
    would pin one bad backlog red forever."""
    return s.histogram_delta_quantile(_registry.SERVE_FRESHNESS_SECONDS, 0.99)


def _epoch_flip_stall(s: Snapshot) -> float:
    """Mutation batches parked in the ingest log while NO epoch flip
    published since the last tick (the write-path twin of
    fusion-queue-stall): badness is the mutlog depth gauge, judged
    against the flip counter's per-tick movement. A draining log —
    however deep — is healthy accumulation; a deep log with a wedged
    flip loop is data that will never become queryable."""
    depth = s.gauge_max_abs(_registry.SERVE_MUTLOG_COUNT)
    if depth <= 0:
        return 0.0
    flips = s.labeled_counter_delta(_registry.SERVE_EPOCH_FLIP_TOTAL)
    drained = sum(
        d for (outcome,), d in flips.items() if outcome == "flipped"
    )
    return depth if drained == 0 else 0.0


def _epoch_persist_stall(s: Snapshot) -> float:
    """Published epochs pending durability while NO persist completed
    since the last tick (the durability twin of
    epoch-flip-stall): badness is the persist-backlog gauge, judged
    against the persist counter's per-tick movement. A backlog the
    priced skip verdict is deliberately carrying is healthy patience; a
    growing backlog with a wedged (or perpetually aborting) persist
    loop is warm state a crash will erase."""
    depth = s.gauge_max_abs(_registry.DURABLE_PENDING_COUNT)
    if depth <= 0:
        return 0.0
    persists = s.labeled_counter_delta(_registry.DURABLE_PERSIST_TOTAL)
    completed = sum(
        d for (outcome,), d in persists.items() if outcome == "persisted"
    )
    return depth if completed == 0 else 0.0


def _recovery_manifest_torn(s: Snapshot) -> float:
    """Torn durable artifacts skipped by recovery since the last tick.
    A torn manifest means a crash landed mid-persist on a
    non-atomic filesystem — or worse, bit rot — and the restart silently
    fell back to an OLDER epoch. Any occurrence goes straight to red
    (one tick, critical), and the critical transition's flight bundle
    carries the durable panel with the recovery provenance."""
    torn = s.labeled_counter_delta(_registry.DURABLE_RECOVERY_TOTAL)
    return float(sum(
        d for (outcome,), d in torn.items() if outcome == "torn"
    ))


def _fusion_queue_stall(s: Snapshot) -> float:
    """Queries parked in the fusion window queue while NO batch drained
    since the last tick: badness is the queue depth gauge, judged
    against the batch counter's per-tick movement; the batch-latency
    histogram (``rb_tpu_fusion_batch_seconds``) carries the drill-down.
    A draining queue — however deep — is healthy backpressure."""
    depth = s.gauge_max_abs(_registry.FUSION_QUEUED_COUNT)
    if depth <= 0:
        return 0.0
    return depth if s.counter_delta(_registry.FUSION_BATCH_TOTAL) == 0 else 0.0


def _serving_p99_pressure(s: Snapshot) -> Optional[float]:
    """Worst per-tenant ratio of windowed serving p99 over that tenant's
    DECLARED p99 budget: 1.0 means some tenant's tail just
    consumed its whole SLO. Unlike ``serving-p99-breach`` (one absolute
    band for everyone), this judges each tenant against its own declared
    latency class, so an interactive tenant at 30 ms fires while a batch
    tenant at 300 ms stays green — and it actuates the fusion-window
    auto-tune instead of an alert, because the batching window is the
    knob that trades this exact tail for throughput. Tenants without a
    declared budget (no ``rb_tpu_serve_slo_budget_seconds`` series) are
    not judged."""
    m = s.metrics.get(_registry.SERVE_SLO_BUDGET_SECONDS)
    if m is None:
        return None
    budgets: Dict[str, float] = {}
    for smp in m.get("samples", ()):
        tenant = smp.get("labels", {}).get("tenant", "")
        v = float(smp.get("value", 0))
        if tenant and v > 0:
            budgets[tenant] = v
    if not budgets:
        return None
    per = s.histogram_delta_quantiles(_registry.SERVE_LATENCY_SECONDS, 0.99)
    worst: Optional[float] = None
    for (tenant, _phase), p99 in per.items():
        budget = budgets.get(tenant)
        if budget is None:
            continue
        ratio = p99 / budget
        worst = ratio if worst is None else max(worst, ratio)
    return worst


DEFAULT_RULES: Tuple[Rule, ...] = (
    Rule(
        "costmodel-drift",
        "a pricing authority's coefficient cell no longer describes live "
        "traffic (geometric-EWMA drift left its band)",
        _drift_badness,
        warn=2.0, critical=4.0, fire_after=2, clear_after=2,
        actuation="refit",
    ),
    Rule(
        "routing-regret",
        "wall-clock lost to wrong routing verdicts exceeds the regret "
        "budget (fraction of joined measured wall)",
        _regret_fraction,
        warn=0.05, critical=0.20, fire_after=3, clear_after=3,
        actuation="alert",
    ),
    Rule(
        "breaker-stuck-open",
        "a circuit breaker has been continuously open past recovery "
        "expectations (seconds)",
        _max_open_age,
        warn=30.0, critical=300.0, fire_after=1, clear_after=1,
        actuation="alert",
    ),
    Rule(
        "outcome-anomaly-burst",
        "out-of-band predicted-vs-measured joins since the last tick",
        lambda s: s.counter_delta(_registry.OUTCOME_ANOMALY_TOTAL),
        warn=1.0, critical=16.0, fire_after=1, clear_after=2,
        actuation="alert",
    ),
    Rule(
        "hbm-accounting-drift",
        "device-memory accounting drift (resident gauge vs cache "
        "ledgers), max |bytes| over sources",
        _hbm_drift_badness,
        warn=1.0, critical=float(1 << 20), fire_after=1, clear_after=1,
        actuation="alert",
    ),
    Rule(
        "compile-storm",
        "library builds since the last tick (the JAX package counts XLA "
        "traces here) — steady state must not rebuild",
        lambda s: s.counter_delta(_registry.COMPILE_TOTAL),
        warn=8.0, critical=32.0, fire_after=1, clear_after=2,
        actuation="alert",
    ),
    Rule(
        "fusion-queue-stall",
        "queries waiting in the fusion window queue while no batch "
        "drained since the last tick (stalled drain loop, not healthy "
        "backpressure)",
        _fusion_queue_stall,
        warn=1.0, critical=64.0, fire_after=2, clear_after=2,
        actuation="alert",
    ),
    # the two serving-shaped rules, judging the serve tier's per-tenant
    # histograms/counters;
    # appended so the earlier rules keep their table positions
    Rule(
        "serving-p99-breach",
        "worst per-tenant serving p99 (seconds, windowed per tick over "
        "queue+execute phases) breached the latency SLO",
        _serving_p99_breach,
        warn=0.5, critical=2.0, fire_after=2, clear_after=2,
        actuation="alert",
    ),
    Rule(
        "tenant-saturation",
        "a tenant's shed fraction of offered requests since the last "
        "tick (sustained quota breach, judged above a per-tick volume "
        "floor)",
        _tenant_saturation,
        warn=0.25, critical=0.75, fire_after=2, clear_after=2,
        actuation="alert",
    ),
    # the two epoch-ledger rules: data freshness joins the
    # latency SLOs as a judged signal, and a wedged flip loop is loud
    # before the backlog becomes an outage; appended so every earlier
    # rule keeps its table position
    Rule(
        "freshness-lag-breach",
        "worst ingest->queryable lag p99 (seconds, windowed per tick "
        "over the per-tenant freshness series) breached the freshness "
        "SLO",
        _freshness_lag_breach,
        warn=2.0, critical=10.0, fire_after=2, clear_after=2,
        actuation="alert",
    ),
    Rule(
        "epoch-flip-stall",
        "mutation batches pending in the ingest log while no epoch flip "
        "published since the last tick (wedged flip loop, not healthy "
        "accumulation)",
        _epoch_flip_stall,
        warn=4.0, critical=64.0, fire_after=2, clear_after=2,
        actuation="alert",
    ),
    # the two structure-observatory rules: corpus shape joins
    # the judged signals — both actuate a priced maintenance pass
    # (serve/maintain.py) under the sentinel's maintain cooldown;
    # appended so every earlier rule keeps its table position
    Rule(
        "structure-drift",
        "watched working sets' actual serialized bytes over the "
        "size-rule optimum (1.0 = every container in its cheapest "
        "format; sustained ingest without maintenance drifts it up)",
        lambda s: s.gauge_max_abs(_registry.STRUCTURE_DRIFT_RATIO),
        warn=1.3, critical=2.0, fire_after=2, clear_after=2,
        actuation="maintain",
    ),
    Rule(
        "delta-accretion",
        "epoch-delta batches folded into the corpus since the last "
        "maintenance pass settled them (unbounded accretion = unbounded "
        "rewrite debt)",
        lambda s: s.gauge_max_abs(_registry.STRUCTURE_ACCRETION_COUNT),
        warn=8.0, critical=64.0, fire_after=2, clear_after=2,
        actuation="maintain",
    ),
    # the two durable-epoch rules: crash exposure and
    # recovery integrity join the judged signals; appended so every
    # earlier rule keeps its table position
    Rule(
        "epoch-persist-stall",
        "published epochs pending durability while no persist completed "
        "since the last tick (wedged or perpetually aborting persist "
        "loop — warm state a crash will erase; a priced skip backlog "
        "that is still draining is healthy patience)",
        _epoch_persist_stall,
        warn=4.0, critical=64.0, fire_after=2, clear_after=2,
        actuation="alert",
    ),
    Rule(
        "recovery-manifest-torn",
        "torn durable artifacts skipped during recovery since the last "
        "tick (restart silently fell back to an older epoch) — any "
        "occurrence is red, and the flight bundle carries the durable "
        "panel's recovery provenance",
        _recovery_manifest_torn,
        warn=0.5, critical=1.0, fire_after=1, clear_after=1,
        actuation="alert",
    ),
    # the SLO-pressure rule: each tenant judged against its
    # OWN declared p99 budget, actuating the fusion-window auto-tune —
    # the knob that trades exactly this tail for throughput; appended so
    # every earlier rule keeps its table position
    Rule(
        "serving-p99-pressure",
        "worst per-tenant windowed serving p99 over that tenant's "
        "declared p99 budget (1.0 = the tail consumed the whole SLO) — "
        "actuates the fusion-window auto-tune under cooldown",
        _serving_p99_pressure,
        warn=1.0, critical=2.0, fire_after=2, clear_after=2,
        actuation="autotune",
    ),
)
