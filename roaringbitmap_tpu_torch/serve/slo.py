"""Per-tenant serving-tier SLO telemetry.

Counterpart of ``roaringbitmap_tpu/serve/slo.py``, with the same series,
tenant registry, latency classes and off mode. A serving tier answers
"what latency and throughput does each *tenant* see, and who is eating
the card", which needs per-tenant labeled series on the registry:

* ``rb_tpu_serve_latency_seconds{tenant, phase}`` — log-bucketed
  latency histograms (phase ``queue`` = the admission wall including any
  backpressure wait, ``execute`` = query execution);
* ``rb_tpu_serve_qps{tenant}`` — rolling per-tenant served throughput
  (sliding window ``QPS_WINDOW_S``);
* ``rb_tpu_serve_requests_total{tenant, outcome}`` — request volume by
  outcome (``ok`` | ``shed`` | ``error``);
* ``rb_tpu_serve_queue_count`` / ``rb_tpu_serve_inflight_count`` — the
  admission controller's live depth gauges (``serve/admission.py``);
* ``rb_tpu_serve_saturation_ratio{tenant}`` — per-tenant token-bucket
  depletion (0 = full budget, 1 = quota exhausted);
* ``rb_tpu_serve_tenant_bytes{tenant}`` — the tenant's byte share of the
  resident ``PACK_CACHE`` working sets on the card (a share, not a
  partition; see :func:`note_tenant_bytes`);
* ``rb_tpu_serve_slo_budget_seconds{tenant}`` — the declared p99 budget
  from the tenant's latency class (:data:`LATENCY_CLASSES`, overridable
  per tenant): admission bounds an interactive queue wait by it, the
  fusion hedge prices window-vs-solo against it, and the
  ``serving-p99-pressure`` rule judges measured p99 against it.

**The bounded tenant registry.** Tenant label values come from
:data:`TENANTS`, a capacity-bounded *declared* registry:
``TENANTS.declare(name, ...)`` registers a tenant (failing past
``max_tenants``) and ``TENANTS[name]`` returns the canonical label value,
raising ``KeyError`` for anything undeclared, so a typo'd tenant never
mints a series. Metric label values are spelled ``TENANTS[tenant]``.

Off mode: ``configure(enabled=False)`` reduces :func:`record` and the
gauge updates to one module-bool check.

Lock discipline: the registry's lock is a leaf — it guards only the
tenant table and the per-tenant QPS rings; every metric bump happens
outside it.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

from ..observe import registry as _registry
from ..observe.histogram import latency_histogram

# rolling-QPS window: long enough to smooth a drained fusion window's
# burstiness, short enough that the gauge tracks load shifts the sentinel
# should see within a few ticks
QPS_WINDOW_S = 5.0
DEFAULT_MAX_TENANTS = 64

# declared latency classes: every tenant picks one, with a
# default p99 budget it may override at declare(). The class is the
# coarse scheduling signal (interactive = latency-gold, hedges out of a
# forming fusion window that would blow its budget; batch = throughput-
# gold, rides every window); the BUDGET is the priced input — admission
# bounds an interactive queue wait by it and the fusion hedge verdict
# prices window-vs-solo against it.
LATENCY_CLASSES: Dict[str, float] = {
    "interactive": 25.0,   # p99 budget ms: human-in-the-loop lookups
    "balanced": 100.0,     # dashboards, near-line consumers
    "batch": 1000.0,       # offline scans: throughput over latency
}
DEFAULT_LATENCY_CLASS = "batch"

# request phases and outcomes (declared label sets; the latency histogram
# registers with labelnames ("tenant", "phase"))
PHASES = ("queue", "execute")
OUTCOMES = ("ok", "shed", "error")

_LATENCY = latency_histogram(
    _registry.SERVE_LATENCY_SECONDS,
    "Serving-tier request latency by tenant and phase (queue = admission "
    "wall incl. backpressure wait, execute = query execution)",
    ("tenant", "phase"),
)
_QPS = _registry.gauge(
    _registry.SERVE_QPS,
    "Rolling per-tenant request throughput (sliding-window rate over "
    "QPS_WINDOW_S seconds)",
    ("tenant",),
)
_REQUESTS_TOTAL = _registry.counter(
    _registry.SERVE_REQUESTS_TOTAL,
    "Serving-tier requests by tenant and outcome (ok | shed | error)",
    ("tenant", "outcome"),
)
_TENANT_BYTES = _registry.gauge(
    _registry.SERVE_TENANT_BYTES,
    "Per-tenant byte share of the resident PACK_CACHE working sets "
    "(overlapping working sets charge every tenant that touches them)",
    ("tenant",),
)
_SLO_BUDGET = _registry.gauge(
    _registry.SERVE_SLO_BUDGET_SECONDS,
    "Per-tenant declared p99 latency budget (seconds) from the tenant's "
    "latency class — what the serving-p99-pressure rule judges measured "
    "p99 against",
    ("tenant",),
)

_ENABLED = True


def configure(enabled: Optional[bool] = None) -> None:
    """``enabled=False`` is the serving off-mode twin's kill switch:
    :func:`record` and the gauge updates reduce to one bool check."""
    global _ENABLED
    if enabled is not None:
        _ENABLED = bool(enabled)


def enabled() -> bool:
    return _ENABLED


class TenantRegistry:
    """Capacity-bounded declared tenant set — the source of every tenant
    metric label value. ``declare()`` past ``max_tenants`` raises (a
    tenant set that grows without bound is the same cardinality bug as a
    trace-id label, just slower); ``registry[name]`` canonicalizes a
    tenant to its declared label value and raises ``KeyError`` for
    anything undeclared, so a typo'd tenant can never mint a series."""

    def __init__(self, max_tenants: int = DEFAULT_MAX_TENANTS):
        if max_tenants < 1:
            raise ValueError(f"max_tenants must be >= 1, got {max_tenants}")
        self.max_tenants = int(max_tenants)
        self._lock = threading.Lock()  # leaf: guards the tables below only
        self._tenants: Dict[str, dict] = {}  # guarded-by: self._lock
        # per-tenant completion-timestamp rings for the rolling QPS gauge
        self._ticks: Dict[str, "deque[float]"] = {}  # guarded-by: self._lock

    def declare(
        self,
        name: str,
        quota_qps: float = 100.0,
        burst: Optional[float] = None,
        latency_class: str = DEFAULT_LATENCY_CLASS,
        p99_budget_ms: Optional[float] = None,
    ) -> str:
        """Register a tenant with its admission quota (token-bucket rate
        ``quota_qps`` and ``burst`` capacity, default 2x the rate) and
        its latency SLO: a declared ``latency_class`` with a p99 budget
        (class default unless ``p99_budget_ms`` overrides it). Idempotent
        for an identical name (quota and SLO update); loud past
        capacity."""
        name = str(name)
        if not name:
            raise ValueError("tenant name must be non-empty")
        if latency_class not in LATENCY_CLASSES:
            raise ValueError(
                f"unknown latency class {latency_class!r} "
                f"(known: {sorted(LATENCY_CLASSES)})"
            )
        budget_ms = (
            float(p99_budget_ms) if p99_budget_ms is not None
            else LATENCY_CLASSES[latency_class]
        )
        spec = {
            "quota_qps": float(quota_qps),
            "burst": float(burst) if burst is not None else 2.0 * float(quota_qps),
            "latency_class": latency_class,
            "p99_budget_ms": budget_ms,
        }
        if spec["quota_qps"] <= 0 or spec["burst"] <= 0:
            raise ValueError(f"tenant {name!r} quota/burst must be > 0: {spec}")
        if budget_ms <= 0:
            raise ValueError(
                f"tenant {name!r} p99 budget must be > 0 ms, got {budget_ms}"
            )
        with self._lock:
            if name not in self._tenants and len(self._tenants) >= self.max_tenants:
                raise ValueError(
                    f"tenant registry full ({self.max_tenants}): declaring "
                    f"{name!r} would unbound the tenant label set"
                )
            self._tenants[name] = spec
            self._ticks.setdefault(name, deque())
        # budget gauge outside the leaf lock, like every metric bump here
        if _ENABLED:
            _SLO_BUDGET.set(round(budget_ms / 1e3, 6), (name,))
        return name

    def __getitem__(self, name: str) -> str:
        """Canonical label value for a declared tenant (KeyError for
        anything undeclared — the bounded-cardinality guarantee)."""
        with self._lock:
            if name not in self._tenants:
                raise KeyError(
                    f"undeclared tenant {name!r} (declared: {sorted(self._tenants)})"
                )
        return name

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._tenants

    def quota(self, name: str) -> dict:
        with self._lock:
            spec = self._tenants.get(name)
            if spec is None:
                raise KeyError(f"undeclared tenant {name!r}")
            return dict(spec)

    def latency_class(self, name: str) -> str:
        with self._lock:
            spec = self._tenants.get(name)
            if spec is None:
                raise KeyError(f"undeclared tenant {name!r}")
            return spec["latency_class"]

    def p99_budget_ms(self, name: str) -> float:
        """The tenant's declared p99 latency budget (ms) — the priced
        input the fusion hedge verdict and the serving-p99-pressure rule
        judge against."""
        with self._lock:
            spec = self._tenants.get(name)
            if spec is None:
                raise KeyError(f"undeclared tenant {name!r}")
            return float(spec["p99_budget_ms"])

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._tenants)

    def reset(self) -> None:
        """Drop every declared tenant (tests, benchmark windows)."""
        with self._lock:
            self._tenants.clear()
            self._ticks.clear()

    # -- rolling QPS ---------------------------------------------------------

    def _note_request(self, tenant: str, now: float) -> float:
        """Append one completion tick and return the tenant's current
        windowed rate (requests in the window / window seconds)."""
        floor = now - QPS_WINDOW_S
        with self._lock:
            ring = self._ticks.get(tenant)
            if ring is None:
                raise KeyError(f"undeclared tenant {tenant!r}")
            ring.append(now)
            while ring and ring[0] < floor:
                ring.popleft()
            n = len(ring)
        return n / QPS_WINDOW_S

    def qps(self, tenant: str, now: Optional[float] = None) -> float:
        """The tenant's current windowed request rate (reads only)."""
        if now is None:
            now = time.monotonic()
        floor = now - QPS_WINDOW_S
        with self._lock:
            ring = self._ticks.get(tenant)
            if ring is None:
                raise KeyError(f"undeclared tenant {tenant!r}")
            n = sum(1 for t in ring if t >= floor)
        return n / QPS_WINDOW_S


# The process-wide tenant registry (harness profiles, admission quotas,
# and every serve-tier metric label value resolve through this).
TENANTS = TenantRegistry()


def record(
    tenant: str,
    outcome: str,
    queue_s: Optional[float] = None,
    execute_s: Optional[float] = None,
    now: Optional[float] = None,
) -> None:
    """Record one served request: phase latencies into the per-tenant
    histograms, the outcome counter, and the rolling QPS gauge. Metric
    bumps happen outside the SLO lock (leaf discipline); disabled mode is
    one bool check."""
    if not _ENABLED:
        return
    if outcome not in OUTCOMES:
        raise ValueError(f"unknown serve outcome {outcome!r} (known: {OUTCOMES})")
    canon = TENANTS[tenant]
    _REQUESTS_TOTAL.inc(1, (TENANTS[tenant], str(outcome)))
    if outcome == "ok":
        # the rolling-QPS gauge is served THROUGHPUT (the help text and
        # the harness's served/wall rows agree on this); offered volume
        # incl. sheds rides the requests counter above — a 100%-shed
        # tenant must read ~0 qps in the serving panel, not healthy
        rate = TENANTS._note_request(
            canon, time.monotonic() if now is None else now
        )
        _QPS.set(round(rate, 3), (TENANTS[tenant],))
    if queue_s is not None:
        _LATENCY.observe(queue_s, (TENANTS[tenant], "queue"))
    if execute_s is not None:
        _LATENCY.observe(execute_s, (TENANTS[tenant], "execute"))


def note_tenant_bytes(tenant: str, leaves: Iterable) -> int:
    """Charge ``tenant`` with the resident PACK_CACHE bytes attributable
    to its working set (the bitmaps its query profile touches): entries
    whose key embeds any of the leaves' fingerprints. Returns the byte
    share and exports it as ``rb_tpu_serve_tenant_bytes{tenant}``."""
    if not _ENABLED:
        return 0
    from ..parallel import store as _store

    fps = {bm.fingerprint() for bm in leaves}
    share = _store.PACK_CACHE.resident_bytes_for(fps)
    _TENANT_BYTES.set(int(share), (TENANTS[tenant],))
    return int(share)


def quantiles(tenant: str, phase: str) -> dict:
    """p50/p90/p99 snapshot for one (tenant, phase) latency series —
    the harness's cross-check against its own collected latencies."""
    return _LATENCY.quantiles((TENANTS[tenant], str(phase)))


def tenant_rows() -> Dict[str, dict]:
    """Per-tenant rollup (the serving panel's rows): rolling QPS,
    p50/p99 per phase, request outcomes, byte share."""
    out: Dict[str, dict] = {}
    req = _REQUESTS_TOTAL.series()
    bytes_g = _TENANT_BYTES.series()
    qps_g = _QPS.series()
    for tenant in TENANTS.names():
        spec = TENANTS.quota(tenant)
        row = {
            "qps": qps_g.get((tenant,), 0.0),
            "bytes": bytes_g.get((tenant,), 0),
            "latency_class": spec.get("latency_class"),
            "p99_budget_ms": spec.get("p99_budget_ms"),
            "outcomes": {
                lv[1]: v for lv, v in req.items() if lv[0] == tenant
            },
        }
        for phase in PHASES:
            st = _LATENCY.get((tenant, phase))
            if st is not None:
                row[phase] = {
                    "count": st["count"],
                    **_LATENCY.quantiles((tenant, phase)),
                }
        out[tenant] = row
    return out


def reset() -> None:
    """Drop tenant declarations and QPS rings (tests, benchmark windows);
    registry metric series reset via observe.reset like everything
    else."""
    TENANTS.reset()
