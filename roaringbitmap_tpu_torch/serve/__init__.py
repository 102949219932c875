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

The write path:

* ``ingest.py`` — the batched mutation log: stamped per-tenant batches
  accumulate while readers keep serving the current epoch untouched;
* ``epochs.py`` — snapshot-isolated epoch publication: readers pin the
  epoch they were admitted under, and the flip drains the log through the
  sorted-stream writer into one delta repack per touched working set on
  the device, observing every published batch's ingest->queryable lag in
  ``rb_tpu_serve_freshness_seconds{tenant}``; the flip is a priced
  ``epoch.flip`` decision (``cost/epoch.py``);
* ``maintain.py`` — priced compaction passes that ride the flip
  (``cost/compaction.py``), the sentinel's ``maintain`` target.

The health sentinel's ``serving-p99-breach``, ``tenant-saturation``,
``serving-p99-pressure``, ``freshness-lag-breach`` and ``epoch-flip-stall``
rules (``observe/health.py``) judge the series this tier registers.
"""

from .admission import CONTROLLER, AdmissionController, ShedRejection, Ticket
from .epochs import EpochStore, EpochTicket, FLIP_STAGES, current_store
from .harness import (
    HarnessReport,
    LoadHarness,
    Request,
    TenantProfile,
    TenantStats,
    build_requests,
    default_mix,
)
from .ingest import IngestLog, MutationBatch
from .slo import TENANTS, TenantRegistry
from . import admission, epochs, harness, ingest, slo

__all__ = [
    "AdmissionController",
    "CONTROLLER",
    "EpochStore",
    "EpochTicket",
    "FLIP_STAGES",
    "HarnessReport",
    "IngestLog",
    "LoadHarness",
    "MutationBatch",
    "Request",
    "ShedRejection",
    "TENANTS",
    "TenantProfile",
    "TenantRegistry",
    "TenantStats",
    "Ticket",
    "admission",
    "build_requests",
    "current_store",
    "default_mix",
    "epochs",
    "harness",
    "ingest",
    "slo",
]
