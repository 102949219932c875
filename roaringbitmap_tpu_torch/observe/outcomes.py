"""Decision–outcome ledger: predicted-vs-measured joins, routing regret,
and the calibration-drift watch.

Counterpart of ``roaringbitmap_tpu/observe/outcomes.py``. Every routing
verdict lands in the decision log with the inputs that drove it, and the
flight recorder measures what each stage took; this module joins the two:

* **Join.** A decision site that wants its verdict scored registers the
  decision as *pending* (``decisions.record_decision(..., outcome=True)``
  returns the decision's process-unique serial) and, after the chosen
  engine ran, resolves it with the measured wall clock
  (:func:`resolve` / the :class:`measure` context manager). The same
  serial is threaded into the flight-recorder span attrs
  (``decision=<seq>`` on the ladder-attempt and query-step spans), so
  :func:`join_recorder` can rebuild the ledger offline from a trace
  artifact.

* **Regret.** When the decision carried per-engine cost estimates
  (``est_us``), the join prices the not-taken alternatives: regret is
  ``measured(chosen) − min(predicted(alternatives))``, counted only when
  some alternative was predicted to beat what happened. Sites with a
  *measured* counterfactual resolve with an explicit ``regret_s``.
  Per-site regret accumulates in ``rb_tpu_decision_regret_seconds{site}``.

* **Calibration drift.** Every join with a prediction observes
  ``predicted/measured`` into ``rb_tpu_decision_error_ratio{site}``. A
  priced join whose ratio leaves the calibrated band dumps the ledger
  tail to a JSONL artifact (throttled to one per second) and bumps
  ``rb_tpu_outcome_anomaly_total{site}``.

  ``columnar.cutoff`` joins additionally feed a per-coefficient-cell
  drift gauge ``rb_tpu_costmodel_drift_ratio{group,engine,shape}``
  (geometric EWMA of measured/predicted — 1.0 means the calibrated curve
  still prices this cell truthfully), the health sentinel's
  ``costmodel-drift`` signal.
* **Refit feed.** :func:`samples` hands joined samples to a refit:
  ``columnar.costmodel.refit_from_outcomes()`` reads the
  ``columnar.cutoff`` joins (op group, engine, shape, pair count,
  measured µs), ``query.plan.CARD_MODEL.refit_from_outcomes()`` the
  planner's.

Bounds & cost: pending decisions live in a bounded map (default 2048) and
joined entries in a bounded ring (default 512); an outcome that arrives
after its decision was evicted is counted as
``rb_tpu_outcome_orphans_total{site}`` and dropped — never an error. Off
mode (``RB_TPU_OUTCOMES=off`` / ``configure(enabled=False)``) reduces
every hook to one module-bool check.

Lock discipline: the ledger lock is a LEAF — it guards only the pending
map, the ring, and the per-site aggregate dicts; metric bumps and the
anomaly dump happen outside it.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

from . import registry as _registry
from . import timeline as _timeline
from .histogram import latency_histogram

DEFAULT_CAPACITY = 512
DEFAULT_PENDING = 2048
# calibrated band for predicted/measured: a join outside [lo, hi] is a
# pricing anomaly (the curves are two-point fits — 4x either way is far
# beyond fit noise and means the coefficient no longer describes traffic)
DEFAULT_BAND = (0.25, 4.0)
DUMP_SCHEMA = "rb_tpu_outcomes/1"
_DUMP_MIN_INTERVAL_NS = 1_000_000_000
# drift EWMA weight: ~20-sample memory, enough to ride out one weird pair
# without hiding a real drift for long
_DRIFT_ALPHA = 0.1

_REGRET_SECONDS = latency_histogram(
    _registry.DECISION_REGRET_SECONDS,
    "Wall-clock lost to wrong routing verdicts, by deciding site "
    "(measured chosen-engine cost minus the best not-taken alternative's "
    "predicted cost, when that alternative was predicted to win)",
    ("site",),
)
# log-bucketed predicted/measured ratio: symmetric decades around 1.0 so
# systematic over- and under-pricing resolve equally
_ERROR_RATIO_BUCKETS = (
    0.0625, 0.125, 0.25, 0.5, 0.75, 0.9, 1.111, 1.333, 2.0, 4.0, 8.0, 16.0,
)
_ERROR_RATIO = _registry.histogram(
    _registry.DECISION_ERROR_RATIO,
    "Predicted/measured cost ratio per joined decision, by site "
    "(1.0 = the model priced this verdict truthfully)",
    ("site",),
    buckets=_ERROR_RATIO_BUCKETS,
)
_JOIN_TOTAL = _registry.counter(
    _registry.OUTCOME_JOIN_TOTAL,
    "Decision outcomes joined to their measured execution, by site",
    ("site",),
)
_ORPHANS_TOTAL = _registry.counter(
    _registry.OUTCOME_ORPHANS_TOTAL,
    "Outcomes that arrived after their decision left the pending ring "
    "(joined lazily impossible — counted, never an error), by site",
    ("site",),
)
_ANOMALY_TOTAL = _registry.counter(
    _registry.OUTCOME_ANOMALY_TOTAL,
    "Joins whose predicted/measured ratio left the calibrated band and "
    "triggered a (throttled) ledger dump, by site",
    ("site",),
)
_DRIFT_RATIO = _registry.gauge(
    _registry.COSTMODEL_DRIFT_RATIO,
    "Geometric EWMA of measured/predicted cost per columnar cost-model "
    "coefficient cell (1.0 = calibration still truthful)",
    ("group", "engine", "shape"),
)


def _init_enabled() -> bool:
    raw = os.environ.get("RB_TPU_OUTCOMES", "").strip().lower()
    return raw not in ("0", "off", "false", "no")


_ENABLED = _init_enabled()


class OutcomeLedger:
    """Thread-safe bounded pending map + joined ring + per-site rollups.

    All state lives behind one LEAF lock; every method returns plain data
    and leaves metric emission to the module-level wrappers (which bump
    outside the lock)."""

    def __init__(
        self, capacity: int = DEFAULT_CAPACITY, pending: int = DEFAULT_PENDING
    ):
        if capacity < 1 or pending < 1:
            raise ValueError(
                f"capacity/pending must be >= 1, got {capacity}/{pending}"
            )
        self._lock = threading.Lock()  # leaf: guards the three dicts only
        self._pending: "OrderedDict[int, dict]" = OrderedDict()  # guarded-by: self._lock
        self._pending_cap = int(pending)  # guarded-by: self._lock
        self._ring: "deque[dict]" = deque(maxlen=int(capacity))  # guarded-by: self._lock
        # site -> {count, regret_s, log_err_sum, log_err_n, worst (entry)}
        self._sites: Dict[str, dict] = {}  # guarded-by: self._lock
        # (group, engine, shape) -> geometric EWMA of measured/predicted
        self._drift: Dict[Tuple[str, str, str], float] = {}  # guarded-by: self._lock

    @property
    def capacity(self) -> int:
        return self._ring.maxlen

    # -- pending ------------------------------------------------------------

    def register(self, seq: int, entry: dict) -> None:
        """Park a decision for a later measured join. Over capacity the
        OLDEST pending decision ages out silently — an unresolved verdict
        is not an error, it simply never produced a sample."""
        with self._lock:
            self._pending[seq] = entry
            while len(self._pending) > self._pending_cap:
                self._pending.popitem(last=False)

    def pop_pending(self, seq: int) -> Optional[dict]:
        with self._lock:
            return self._pending.pop(seq, None)

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    # -- joined entries ------------------------------------------------------

    def append(self, joined: dict) -> None:
        site = joined["site"]
        regret = joined.get("regret_s") or 0.0
        err = joined.get("error_ratio")
        measured = joined.get("measured_s") or 0.0
        with self._lock:
            self._ring.append(joined)
            agg = self._sites.get(site)
            if agg is None:
                agg = self._sites[site] = {
                    "count": 0, "regret_s": 0.0, "measured_s": 0.0,
                    "log_err_sum": 0.0, "log_err_n": 0, "worst": None,
                }
            agg["count"] += 1
            agg["regret_s"] += regret
            # cumulative measured wall: the denominator of a site's
            # routing-regret fraction
            agg["measured_s"] += measured
            if err is not None and err > 0:
                agg["log_err_sum"] += math.log(err)
                agg["log_err_n"] += 1
            worst = agg["worst"]
            if regret > 0 and (worst is None or regret > worst.get("regret_s", 0.0)):
                agg["worst"] = joined

    def note_drift(self, cell: Tuple[str, str, str], ratio: float) -> float:
        """Fold one measured/predicted sample into the cell's geometric
        EWMA; returns the updated drift value (emitted by the caller)."""
        with self._lock:
            prev = self._drift.get(cell)
            if prev is None or prev <= 0:
                cur = ratio
            else:
                cur = math.exp(
                    (1 - _DRIFT_ALPHA) * math.log(prev)
                    + _DRIFT_ALPHA * math.log(ratio)
                )
            self._drift[cell] = cur
            return cur

    def drift(self) -> Dict[Tuple[str, str, str], float]:
        with self._lock:
            return dict(self._drift)

    def rebase_drift(self, cells) -> None:
        """Re-base the given cells' EWMAs to 1.0 — called after a refit
        replaced their coefficients: the accumulated drift measured the OLD
        curve's error."""
        with self._lock:
            for cell in cells:
                if cell in self._drift:
                    self._drift[cell] = 1.0

    def tail(self, n: Optional[int] = None) -> List[dict]:
        """The newest ``n`` joined entries (all retained when None),
        oldest first — point-in-time copies, safe to mutate."""
        with self._lock:
            entries = list(self._ring)
        if n is not None:
            entries = entries[-int(n):] if n > 0 else []
        return [dict(e) for e in entries]

    def summary(self) -> Dict[str, dict]:
        """Per-site rollup: join count, total regret seconds, geometric
        mean error ratio, and the worst (highest-regret) recent decision
        with its inputs."""
        with self._lock:
            out = {}
            for site, agg in sorted(self._sites.items()):
                n = agg["log_err_n"]
                out[site] = {
                    "count": agg["count"],
                    "regret_s": round(agg["regret_s"], 6),
                    "measured_s": round(agg["measured_s"], 6),
                    "error_ratio_geomean": (
                        round(math.exp(agg["log_err_sum"] / n), 4) if n else None
                    ),
                    "worst": dict(agg["worst"]) if agg["worst"] else None,
                }
            return out

    def clear(self) -> None:
        with self._lock:
            self._pending.clear()
            self._ring.clear()
            self._sites.clear()
            self._drift.clear()

    def resize(self, capacity: Optional[int] = None, pending: Optional[int] = None) -> None:
        with self._lock:
            if capacity is not None:
                if capacity < 1:
                    raise ValueError(f"capacity must be >= 1, got {capacity}")
                self._ring = deque(self._ring, maxlen=int(capacity))
            if pending is not None:
                if pending < 1:
                    raise ValueError(f"pending must be >= 1, got {pending}")
                self._pending_cap = int(pending)
                while len(self._pending) > self._pending_cap:
                    self._pending.popitem(last=False)


def _env_int(name: str, default: int) -> int:
    try:
        return max(1, int(os.environ.get(name) or default))
    except ValueError:
        return default


LEDGER = OutcomeLedger(
    capacity=_env_int("RB_TPU_OUTCOMES_CAPACITY", DEFAULT_CAPACITY),
    pending=_env_int("RB_TPU_OUTCOMES_PENDING", DEFAULT_PENDING),
)

_STATE_LOCK = threading.Lock()
_BAND = DEFAULT_BAND  # guarded-by: _STATE_LOCK
_DUMP_PATH = os.environ.get(  # guarded-by: _STATE_LOCK
    "RB_TPU_OUTCOMES_DUMP", "rb_tpu_outcomes_anomaly.jsonl"
)
_LAST_DUMP_NS = 0  # guarded-by: _STATE_LOCK


def configure(
    enabled: Optional[bool] = None,
    capacity: Optional[int] = None,
    pending: Optional[int] = None,
    band: Optional[Tuple[float, float]] = None,
    dump_path: Optional[str] = None,
) -> None:
    """Runtime overrides: ``enabled=False`` is the kill switch (every hook
    reduces to one bool check); ``band`` re-arms the
    anomaly watch ((lo, hi) predicted/measured limits)."""
    global _ENABLED, _BAND, _DUMP_PATH
    if enabled is not None:
        _ENABLED = bool(enabled)
    if capacity is not None or pending is not None:
        LEDGER.resize(capacity=capacity, pending=pending)
    with _STATE_LOCK:
        if band is not None:
            lo, hi = float(band[0]), float(band[1])
            if not 0 < lo < hi:
                raise ValueError(f"band needs 0 < lo < hi, got {band}")
            _BAND = (lo, hi)
        if dump_path is not None:
            _DUMP_PATH = dump_path


def enabled() -> bool:
    return _ENABLED


def register(seq: int, site: str, inputs: Optional[dict], trace) -> None:
    """Park a recorded decision for its measured join (called by
    ``decisions.record_decision`` when the site asked for an outcome)."""
    if not _ENABLED:
        return
    LEDGER.register(seq, {
        "seq": seq, "site": site, "trace": trace,
        "ts_ns": time.perf_counter_ns(),
        "inputs": dict(inputs) if inputs else {},
    })


def resolve(
    seq: Optional[int],
    site: str,
    measured_s: float,
    engine: Optional[str] = None,
    regret_s: Optional[float] = None,
    actual: Optional[float] = None,
) -> Optional[dict]:
    """Join one measured execution to its pending decision.

    ``engine`` names what actually ran (for regret/drift it is looked up
    in the decision's ``est_us``); ``regret_s`` is the explicit
    measured-counterfactual form (evict-then-repack, wasted ladder
    attempt) and overrides the priced estimate; ``actual`` is the
    measured prediction target for non-time predictions (the planner's
    cardinality). ``site`` labels the orphan counter when the pending
    entry is gone (the joined entry itself always carries the decision's
    own site). A ``seq`` that is no longer pending counts as an orphan
    and returns None — never an error (the decision ring is bounded; the
    outcome simply outlived it)."""
    if not _ENABLED or seq is None:
        return None
    entry = LEDGER.pop_pending(seq)
    if entry is None:
        _ORPHANS_TOTAL.inc(1, (site or "unknown",))
        return None
    site = entry.get("site") or site or "unknown"
    inputs = entry.get("inputs") or {}
    measured_us = measured_s * 1e6
    est_us = inputs.get("est_us")
    predicted_us = None
    error_ratio = None
    if isinstance(est_us, dict) and engine is not None:
        predicted_us = est_us.get(engine)
    if predicted_us is not None and measured_us > 0:
        error_ratio = predicted_us / measured_us
    elif (
        actual is not None and actual > 0
        and (inputs.get("est_card") or 0) > 0
    ):
        # non-time prediction (planner cardinality): predicted/measured in
        # the prediction's own unit — the same drift semantics
        error_ratio = float(inputs["est_card"]) / float(actual)
    if regret_s is None and isinstance(est_us, dict) and engine is not None:
        alts = [v for k, v in est_us.items() if k != engine and v is not None]
        if alts:
            best_alt_us = min(alts)
            if best_alt_us < measured_us:
                regret_s = (measured_us - best_alt_us) / 1e6
    joined = {
        "seq": seq,
        "site": site,
        "trace": entry.get("trace"),
        "engine": engine,
        "measured_s": round(measured_s, 9),
        "predicted_us": predicted_us,
        "error_ratio": round(error_ratio, 6) if error_ratio is not None else None,
        "regret_s": round(regret_s, 9) if regret_s else 0.0,
        "inputs": inputs,
    }
    if actual is not None:
        joined["actual"] = actual
    LEDGER.append(joined)
    # metrics OUTSIDE the ledger lock (leaf discipline)
    _JOIN_TOTAL.inc(1, (site,))
    if joined["regret_s"]:
        _REGRET_SECONDS.observe(joined["regret_s"], (site,))
    if error_ratio is not None:
        _ERROR_RATIO.observe(error_ratio, (site,))
        if site == "columnar.cutoff" and predicted_us is not None:
            _note_cell_drift(inputs, engine, measured_us, predicted_us)
        # the calibrated band judges PRICED joins only (predicted_us from
        # measured cost curves — 4x off a two-point fit is an anomaly);
        # cardinality-style ratios (the planner's structural bounds) are
        # EXPECTED to miss by orders of magnitude until a refit learns
        # the traffic's bias — banding them would dump once per second on
        # perfectly healthy query traffic and drown the real alerts
        if predicted_us is not None:
            with _STATE_LOCK:
                lo, hi = _BAND
            if not lo <= error_ratio <= hi:
                _anomaly(site, joined)
    return joined


_COSTMODEL = None


def _note_cell_drift(inputs, engine, measured_us, predicted_us) -> None:
    """Fold a columnar.cutoff join into its coefficient cell's drift
    gauge; the cell is the exact (op-group, engine, shape) the cost model
    fits — drift 1.0 means the two-point calibration still prices live
    traffic truthfully."""
    global _COSTMODEL
    _costmodel = _COSTMODEL
    if _costmodel is None:
        # imported on the first join (the columnar package imports this
        # one), then held: every routed facade call joins here
        from ..columnar import costmodel as _costmodel

        _COSTMODEL = _costmodel
    op = inputs.get("op")
    shape = inputs.get("shape")
    if op is None or shape not in _costmodel.SHAPES or engine not in _costmodel.ENGINES:
        return
    group = _costmodel.op_group(op)
    cell = (group, engine, shape)
    ratio = measured_us / predicted_us if predicted_us > 0 else None
    if ratio is None or ratio <= 0:
        return
    drift = LEDGER.note_drift(cell, ratio)
    _DRIFT_RATIO.set(round(drift, 4), cell)


class measure:
    """Context manager resolving a pending decision with the wall clock of
    the enclosed block::

        with outcomes.measure(seq, "columnar.cutoff", engine=tier):
            result = run_the_engine()

    ``seq=None`` (site below its record gate, outcomes off) is a no-op —
    call sites need no conditional. The engine may be (re)assigned via
    ``.engine`` before the block exits (ladder sites learn which tier
    absorbed the traffic mid-block)."""

    __slots__ = ("seq", "site", "engine", "_t0")

    def __init__(self, seq: Optional[int], site: str, engine: Optional[str] = None):
        self.seq = seq if _ENABLED else None
        self.site = site
        self.engine = engine
        self._t0 = 0

    def __enter__(self) -> "measure":
        if self.seq is not None:
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if self.seq is None:
            return
        if exc_type is not None:
            # the engine raised: the ladder/degrade path owns the regret
            # accounting for failures; drop the pending entry silently
            LEDGER.pop_pending(self.seq)
            return
        t1 = time.perf_counter_ns()
        resolve(self.seq, self.site, (t1 - self._t0) / 1e9, engine=self.engine)
        # thread the serial into the flight recorder (the join key):
        # the measured window lands as a span whose attrs carry the
        # decision serial, so join_recorder() can rebuild this join from
        # a dumped trace artifact
        if _timeline.enabled():
            _timeline._record_complete(
                "outcome." + self.site, "outcome", self._t0, t1 - self._t0,
                {"decision": self.seq, "engine": self.engine},
            )


# ---------------------------------------------------------------------------
# refit feed + offline recorder join
# ---------------------------------------------------------------------------


def samples(site: str = "columnar.cutoff", n: Optional[int] = None) -> List[dict]:
    """Joined samples for ``site`` in refit-ready shape. For the columnar
    cutoff each sample carries ``{op, engine, shape, n, measured_us}`` —
    the features the JAX package's ``costmodel.refit_from_outcomes`` fits
    on; other sites get their joined entries as-is."""
    out = []
    for e in LEDGER.tail(n):
        if e["site"] != site:
            continue
        if site == "columnar.cutoff":
            inputs = e.get("inputs") or {}
            na, nb = inputs.get("na"), inputs.get("nb")
            if na is None or nb is None or e.get("engine") is None:
                continue
            out.append({
                "op": inputs.get("op", "and"),
                "engine": e["engine"],
                "shape": inputs.get("shape"),
                "n": min(int(na), int(nb)),
                "measured_us": e["measured_s"] * 1e6,
            })
        else:
            out.append(dict(e))
    return out


def join_recorder(events, decisions_tail: Optional[List[dict]] = None) -> List[dict]:
    """Offline join over a flight-recorder window: complete spans whose
    attrs carry a ``decision`` serial are matched to the decision entries
    (by serial, cross-checked by trace id when both sides carry one) —
    the artifact-side view of the same ledger, usable on a dumped trace
    long after the live pending ring moved on."""
    from . import decisions as _decisions

    if decisions_tail is None:
        decisions_tail = _decisions.decisions()
    by_seq = {d.get("seq"): d for d in decisions_tail if d.get("seq") is not None}
    joined = []
    for e in events:
        if getattr(e, "ph", None) != "X" or not getattr(e, "attrs", None):
            continue
        seq = e.attrs.get("decision")
        if seq is None:
            continue
        d = by_seq.get(seq)
        if d is None:
            continue
        if d.get("trace") and e.trace and d["trace"] != e.trace:
            continue  # serial reuse across traces cannot happen, but be strict
        joined.append({
            "seq": seq,
            "site": d["site"],
            "decision": d["decision"],
            "trace": e.trace,
            "span": e.name,
            "measured_s": e.dur_ns / 1e9,
            "inputs": d.get("inputs", {}),
        })
    return joined


def summary() -> Dict[str, dict]:
    """Per-site regret/error rollup."""
    return LEDGER.summary()


def tail(n: Optional[int] = None) -> List[dict]:
    return LEDGER.tail(n)


def drift() -> Dict[str, float]:
    """Current per-coefficient-cell drift as ``{"group/engine/shape": r}``."""
    return {"/".join(cell): round(v, 4) for cell, v in sorted(LEDGER.drift().items())}


def rebase_drift(cells=None) -> None:
    """Re-base drift EWMAs (and their gauge series) to 1.0 after a refit
    replaced the underlying coefficients; ``cells`` is an iterable of
    ``(group, engine, shape)`` tuples or ``"group/engine/shape"`` strings
    (None = every tracked cell). The cost facade calls this with exactly
    the cells a refit moved."""
    tracked = LEDGER.drift()
    if cells is None:
        chosen = list(tracked)
    else:
        chosen = []
        for c in cells:
            cell = tuple(c.split("/")) if isinstance(c, str) else tuple(c)
            if cell in tracked:
                chosen.append(cell)
    LEDGER.rebase_drift(chosen)
    for cell in chosen:
        _DRIFT_RATIO.set(1.0, cell)


def reset() -> None:
    """Drop all ledger state (tests, measurement windows); metrics keep their
    registry series (reset those via observe.reset like everything else)."""
    LEDGER.clear()


# ---------------------------------------------------------------------------
# anomaly dump (throttled, off the caller's critical path)
# ---------------------------------------------------------------------------


def _anomaly(site: str, joined: dict) -> None:
    global _LAST_DUMP_NS
    _ANOMALY_TOTAL.inc(1, (site,))
    now = time.perf_counter_ns()
    with _STATE_LOCK:
        if _LAST_DUMP_NS and now - _LAST_DUMP_NS < _DUMP_MIN_INTERVAL_NS:
            return
        _LAST_DUMP_NS = now
        path = _DUMP_PATH
        band = _BAND
    entries = LEDGER.tail()
    header = {
        "schema": DUMP_SCHEMA,
        "generated_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "trigger": {k: joined.get(k) for k in
                    ("seq", "site", "engine", "error_ratio", "regret_s")},
        "band": list(band),
        "entries": len(entries),
    }

    def _write():
        from . import artifacts as _artifacts
        from .export import _atomic_write

        try:
            lines = [json.dumps(header, sort_keys=True)]
            lines.extend(json.dumps(e, sort_keys=True, default=str) for e in entries)
            # bare filenames land in the artifact sink, never loose in
            # the working directory
            _atomic_write(_artifacts.resolve(path), "\n".join(lines) + "\n")
        except OSError:  # diagnostics must never kill the instrumented pipeline; the anomaly counter above still recorded the trigger
            pass

    threading.Thread(target=_write, name="rb-outcomes-dump", daemon=True).start()
