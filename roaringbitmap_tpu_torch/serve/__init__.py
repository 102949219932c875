"""Serving tier, read path: multi-tenant load harness, per-tenant SLO
telemetry and priced admission control over the fused query path.

Counterpart of ``roaringbitmap_tpu/serve/`` (see each module):

* ``harness.py`` — the multi-threaded load generator: seeded
  multi-tenant request schedules with overlapping predicates over a
  shared corpus, every request under its own trace scope, driven through
  admission into the :class:`~roaringbitmap_tpu_torch.query.FusionExecutor`;
* ``slo.py`` — the bounded declared tenant registry and the per-tenant
  labeled telemetry (latency p50/p99 per phase, rolling QPS, saturation,
  resident byte shares, declared p99 budgets);
* ``admission.py`` — token-bucket per-tenant quotas + a global in-flight
  cap with shed-or-queue backpressure, every verdict priced at the
  ``serve.admit`` decision site (``cost/admission.py``).

The health sentinel's ``serving-p99-breach``, ``tenant-saturation`` and
``serving-p99-pressure`` rules (``observe/health.py``) judge the series
this tier registers. The write path (``ingest``, ``epochs``,
``maintain``) comes with the durable tier (ROADMAP Queue A).
"""

from .admission import CONTROLLER, AdmissionController, ShedRejection, Ticket
from .harness import (
    HarnessReport,
    LoadHarness,
    Request,
    TenantProfile,
    TenantStats,
    build_requests,
    default_mix,
)
from .slo import TENANTS, TenantRegistry
from . import admission, harness, slo

__all__ = [
    "AdmissionController",
    "CONTROLLER",
    "HarnessReport",
    "LoadHarness",
    "Request",
    "ShedRejection",
    "TENANTS",
    "TenantProfile",
    "TenantRegistry",
    "TenantStats",
    "Ticket",
    "admission",
    "build_requests",
    "default_mix",
    "harness",
    "slo",
]
