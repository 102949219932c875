"""Multi-tenant serving load harness, read and write paths.

Counterpart of ``roaringbitmap_tpu/serve/harness.py``: a multi-threaded
load generator driving the fused query path over a shared corpus with a
seeded multi-tenant workload mix.

* **Workload** — :func:`build_requests` derives, from one seed, a
  deterministic request schedule over declared tenant profiles, the same
  schedule the JAX package builds for the same seed and corpus: each
  tenant draws its queries from its own seeded stream, with a hot shared
  conjunction (``corpus[0] & corpus[1]``) under every tenant's own
  predicates — one hash-consed node across tenants, which the fusion
  window dedups across concurrent submitters.

* **Drive** — :meth:`LoadHarness.run` executes the schedule on
  ``threads`` worker threads (closed loop; ``target_qps`` paces an open
  loop instead). Every request runs under its own ``trace_scope`` and
  passes admission (``serve.admit``) before it is submitted to one shared
  :class:`~roaringbitmap_tpu_torch.query.FusionExecutor` with its tenant,
  whose declared budget prices the hedge (or the plain executor with
  ``use_fusion=False``). The device steps run on
  ``aggregation.config.device``: on the card, its kernels.

* **Account** — phase latencies land in
  ``rb_tpu_serve_latency_seconds{tenant, phase}``, outcomes in the
  request counter, rolling QPS in the per-tenant gauge, and each tenant's
  resident byte share in ``rb_tpu_serve_tenant_bytes`` — the series the
  ``serving-p99-breach``, ``tenant-saturation`` and
  ``serving-p99-pressure`` rules judge.

A shed request yields a :class:`~.admission.ShedRejection` in its result
slot — typed, never a bitmap — so the serial oracle (:meth:`run_serial`)
can check that every served result is exact and every unserved one is
loudly a shed.

* **Writes** — with ``epoch_store=`` (an :class:`~.epochs.EpochStore`
  over the harness corpus, by identity) every query runs under a reader
  pin and a writer tenant's requests (``TenantProfile(writes=...)``) are
  stamped mutation batches into the store's ingest log, each followed by
  the priced ``maybe_flip`` verdict; the run ends with a flip of whatever
  the log still holds. The report keeps each query's admitted epoch and
  each write's batch id, which :meth:`LoadHarness.run_serial_epochs`
  replays serially over a clone of the corpus.
"""

from __future__ import annotations

import contextlib
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..observe import context as _context
from ..observe import timeline as _timeline
from . import slo as _slo
from .admission import CONTROLLER, AdmissionController, ShedRejection
from .slo import TENANTS


@dataclass(frozen=True)
class TenantProfile:
    """One tenant's declared traffic shape: its share of the request mix
    (``weight``), its admission quota, its query profile over the shared
    corpus (``mix`` draws one expression from a seeded rng), and its
    latency SLO (``latency_class`` / ``p99_budget_ms``, the class default
    unless overridden). ``writes`` makes the tenant a writer: that
    fraction of its requests are stamped mutation batches into the epoch
    store's ingest log instead of queries (``write_values`` values a
    batch, drawn into the touched bitmap's existing chunk keys, so the
    flip's repack stays on the delta route)."""

    name: str
    weight: float = 1.0
    quota_qps: float = 1000.0
    burst: Optional[float] = None
    mix: Optional[Callable] = None  # (rng, corpus, shared) -> Expr
    writes: float = 0.0
    write_values: int = 8
    latency_class: str = _slo.DEFAULT_LATENCY_CLASS
    p99_budget_ms: Optional[float] = None


@dataclass
class Request:
    """One scheduled request (the multiset element the serial oracle
    replays). ``kind`` is ``query`` or ``write``; a write carries its
    per-bitmap-index ``mutations`` instead of an expression."""

    idx: int
    tenant: str
    expr: object
    start_s: Optional[float] = None  # open-loop schedule offset
    kind: str = "query"
    mutations: Optional[Dict[int, object]] = None


@dataclass
class TenantStats:
    served: int = 0
    shed: int = 0
    queued: int = 0
    writes: int = 0
    queue_s: List[float] = field(default_factory=list)
    execute_s: List[float] = field(default_factory=list)

    def quantile_ms(self, phase: str, q: float) -> Optional[float]:
        vals = sorted(self.queue_s if phase == "queue" else self.execute_s)
        if not vals:
            return None
        i = min(len(vals) - 1, int(q * len(vals)))
        return round(vals[i] * 1e3, 3)

    def total_quantile_ms(self, q: float) -> Optional[float]:
        """End-to-end (queue + execute) latency quantile — what a
        tenant's declared p99 budget is judged against (the two phase
        lists are appended pairwise under the stats lock)."""
        vals = sorted(a + b for a, b in zip(self.queue_s, self.execute_s))
        if not vals:
            return None
        i = min(len(vals) - 1, int(q * len(vals)))
        return round(vals[i] * 1e3, 3)


def default_mix(rng, corpus, shared):
    """The serving-shaped default query profile: the hot shared
    conjunction under this draw's own predicates, occasionally a pure
    own-predicate scan."""
    from ..query import Q

    a = Q.leaf(corpus[int(rng.integers(0, len(corpus)))])
    b = Q.leaf(corpus[int(rng.integers(0, len(corpus)))])
    kind = int(rng.integers(0, 4))
    if kind == 0:
        return shared | a
    if kind == 1:
        return (shared | a) - b
    if kind == 2:
        return shared | (a & b)
    return a | b


def default_write(rng, corpus, n_values: int = 8):
    """The default mutation draw for a writer tenant: a few values into
    one bitmap's existing chunk keys (drawn as the JAX package draws
    them, so schedules with writers stay equal)."""
    idx = int(rng.integers(0, len(corpus)))
    hlc = corpus[idx].high_low_container
    if hlc.size:
        hb = int(hlc.keys[int(rng.integers(0, hlc.size))])
    else:
        hb = 0
    lows = rng.integers(0, 1 << 16, size=max(1, int(n_values)))
    return {idx: ((hb << 16) | lows).astype(np.int64)}


def zlib_crc(s: str) -> int:
    return zlib.crc32(s.encode())


def build_requests(
    corpus: Sequence,
    profiles: Sequence[TenantProfile],
    n_requests: int,
    seed: int = 0,
    target_qps: Optional[float] = None,
) -> List[Request]:
    """The deterministic request schedule: tenants drawn by weight, each
    tenant's requests from its own seeded stream (two tenants never share
    an rng, and the multiset is reproducible per seed), the shared hot
    conjunction built from the corpus head. ``target_qps`` stamps
    open-loop start offsets; None leaves the schedule closed-loop."""
    from ..query import Q

    if len(corpus) < 4:
        raise ValueError(f"serving corpus needs >= 4 bitmaps, got {len(corpus)}")
    if not profiles:
        raise ValueError("at least one tenant profile is required")
    shared = Q.leaf(corpus[0]) & Q.leaf(corpus[1])
    weights = np.asarray([max(1e-9, p.weight) for p in profiles], dtype=np.float64)
    weights /= weights.sum()
    pick_rng = np.random.default_rng(seed)
    tenant_rngs = {
        p.name: np.random.default_rng((seed << 8) ^ zlib_crc(p.name))
        for p in profiles
    }
    out: List[Request] = []
    for i in range(int(n_requests)):
        p = profiles[int(pick_rng.choice(len(profiles), p=weights))]
        rng = tenant_rngs[p.name]
        start = (i / target_qps) if target_qps else None
        if p.writes > 0 and float(rng.random()) < p.writes:
            muts = default_write(rng, corpus, n_values=p.write_values)
            out.append(Request(
                idx=i, tenant=p.name, expr=None, start_s=start,
                kind="write", mutations=muts,
            ))
            continue
        mix = p.mix or default_mix
        expr = mix(rng, corpus, shared)
        out.append(Request(idx=i, tenant=p.name, expr=expr, start_s=start))
    return out


class LoadHarness:
    """The serving-tier load generator. Construct with the shared corpus
    and tenant profiles (declared into the tenant registry), then
    :meth:`run` a request schedule across worker threads."""

    def __init__(
        self,
        corpus: Sequence,
        profiles: Sequence[TenantProfile],
        threads: int = 4,
        use_fusion: bool = True,
        window: Optional[int] = None,
        max_wait_ms: Optional[float] = None,
        admission: Optional[AdmissionController] = None,
        cache_entries: int = 256,
        epoch_store=None,
    ):
        if threads < 1:
            raise ValueError(f"threads must be >= 1, got {threads}")
        self.corpus = list(corpus)
        self.profiles = list(profiles)
        self.threads = int(threads)
        self.use_fusion = bool(use_fusion)
        self.window = window
        self.max_wait_ms = max_wait_ms
        self.admission = admission if admission is not None else CONTROLLER
        self.cache_entries = int(cache_entries)
        # with an epoch store every query runs under a reader pin and the
        # write requests feed its ingest log; writer profiles need one
        self.epoch_store = epoch_store
        if epoch_store is not None and (
            len(epoch_store.corpus) != len(self.corpus)
            or any(a is not b for a, b in zip(epoch_store.corpus, self.corpus))
        ):  # identity, not content: a content compare of serving-scale
            # bitmaps would cost more than the run it guards
            raise ValueError("epoch store must wrap the harness corpus")
        if epoch_store is None and any(p.writes > 0 for p in self.profiles):
            raise ValueError("writer tenants need an epoch_store")
        for p in self.profiles:
            TENANTS.declare(
                p.name, quota_qps=p.quota_qps, burst=p.burst,
                latency_class=p.latency_class, p99_budget_ms=p.p99_budget_ms,
            )

    def run(self, requests: Sequence[Request]) -> "HarnessReport":
        """Execute the schedule: ``threads`` workers pull requests from a
        shared cursor, each request under its own trace scope through
        admission -> fused execution -> SLO accounting. Returns the report
        with per-request results (bitmap or ShedRejection), positional in
        the schedule as passed, and per-tenant stats."""
        from ..query import FusionExecutor, ResultCache
        from ..query import exec as _exec

        requests = list(requests)
        if self.epoch_store is None and any(r.kind == "write" for r in requests):
            raise ValueError("write requests need an epoch_store")
        results: List[object] = [None] * len(requests)
        # per-position admitted epoch (queries) and minted batch id
        # (writes): the epoch-replay oracle's join keys
        epochs: List[Optional[int]] = [None] * len(requests)
        batch_ids: List[Optional[int]] = [None] * len(requests)
        stats: Dict[str, TenantStats] = {p.name: TenantStats() for p in self.profiles}
        stats_lock = threading.Lock()  # leaf: guards the stats dict only
        cursor = {"i": 0}
        cursor_lock = threading.Lock()  # leaf: guards the cursor only
        errors: List[BaseException] = []
        cache = ResultCache(max_entries=self.cache_entries)
        executor = (
            FusionExecutor(
                window=self.window, max_wait_ms=self.max_wait_ms, cache=cache
            )
            if self.use_fusion
            else None
        )
        epoch_start = (
            self.epoch_store.current() if self.epoch_store is not None else 0
        )
        t_open = time.perf_counter()

        def _next() -> Optional[tuple]:
            with cursor_lock:
                i = cursor["i"]
                if i >= len(requests):
                    return None
                cursor["i"] = i + 1
            return i, requests[i]

        def _serve_one(pos: int, req: Request) -> None:
            with _context.trace_scope():
                if req.start_s is not None:  # open-loop pacing
                    delay = (t_open + req.start_s) - time.perf_counter()
                    if delay > 0:
                        time.sleep(delay)
                ambient_epoch = (
                    self.epoch_store.current()
                    if self.epoch_store is not None else None
                )
                with _timeline.tspan(
                    "serve.request", "serve", tenant=req.tenant, idx=req.idx,
                    kind=req.kind,
                ) as span:
                    t0 = time.perf_counter()
                    ticket = self.admission.admit(req.tenant, epoch=ambient_epoch)
                    queue_s = time.perf_counter() - t0
                    if not ticket.admitted:
                        results[pos] = ShedRejection(req.tenant, "admission")
                        _slo.record(req.tenant, "shed", queue_s=queue_s)
                        with stats_lock:
                            stats[req.tenant].shed += 1
                        return
                    try:
                        t1 = time.perf_counter()
                        if req.kind == "write":
                            # a stamped batch into the ingest log (readers
                            # untouched), then the priced flip-now-vs-
                            # accumulate verdict; the flip is the only
                            # corpus mutation point
                            batch = self.epoch_store.submit(req.tenant, req.mutations)
                            self.epoch_store.maybe_flip(reason="ingest")
                            out = ("write", batch.batch_id if batch else None)
                            batch_ids[pos] = out[1]
                        else:
                            # the reader pin fixes the epoch for the whole
                            # execution; its id rides the request's span
                            pin = (
                                self.epoch_store.reader()
                                if self.epoch_store is not None
                                else contextlib.nullcontext()
                            )
                            with pin as tk:
                                if tk is not None:
                                    epochs[pos] = tk.epoch
                                    if span is not None:  # off mode: no span
                                        span.attr(epoch=tk.epoch)
                                if executor is not None:
                                    # the tenant rides along so the executor
                                    # can price the request's slack against
                                    # its declared SLO
                                    out = executor.submit(
                                        req.expr, tenant=req.tenant
                                    ).result()
                                else:
                                    out = _exec.execute(req.expr, cache=cache)
                        execute_s = time.perf_counter() - t1
                    except Exception:
                        _slo.record(req.tenant, "error", queue_s=queue_s)
                        raise
                    finally:
                        ticket.release()
                    results[pos] = out
                    _slo.record(
                        req.tenant, "ok", queue_s=queue_s, execute_s=execute_s
                    )
                    with stats_lock:
                        st = stats[req.tenant]
                        st.served += 1
                        st.queue_s.append(queue_s)
                        st.execute_s.append(execute_s)
                        if req.kind == "write":
                            st.writes += 1
                        if ticket.verdict == "queue":
                            st.queued += 1

        def _worker() -> None:
            while True:
                nxt = _next()
                if nxt is None:
                    return
                try:
                    _serve_one(*nxt)
                except BaseException as e:  # rb-ok: exception-hygiene -- a worker drains the schedule and the run raises the first failure after the join: swallowing one would shrink the served multiset the oracle checks
                    with stats_lock:
                        errors.append(e)

        workers = [
            threading.Thread(target=_worker, name=f"rb-serve-{i}", daemon=True)
            for i in range(self.threads)
        ]
        t0 = time.perf_counter()
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        wall_s = time.perf_counter() - t0
        if executor is not None:
            executor.close()
        if errors:
            raise errors[0]
        # the run-end flip, after the wall: every accepted batch becomes
        # queryable, trailing freshness is observed and the epoch-replay
        # oracle sees a complete lineage
        if self.epoch_store is not None and self.epoch_store.log.depth():
            self.epoch_store.flip(reason="run-end")
        # per-tenant byte share: the tenant's reachable corpus is the whole
        # shared corpus under the default mixes — charge the resident
        # entries its leaves appear in
        for p in self.profiles:
            _slo.note_tenant_bytes(p.name, self.corpus)
        lineage = (
            self.epoch_store.lineage() if self.epoch_store is not None else []
        )
        return HarnessReport(
            requests, results, stats, wall_s,
            epochs=epochs, batch_ids=batch_ids, lineage=lineage,
            epoch_start=epoch_start, profiles=self.profiles,
        )

    def run_serial(self, requests: Sequence[Request]) -> List[object]:
        """The serial oracle: the same query multiset, one at a time, no
        admission, no fusion, no shared cache — what the concurrent run
        must equal byte for byte. Read-only schedules only; read-write
        schedules use :meth:`run_serial_epochs`."""
        from ..query import exec as _exec

        if any(r.kind == "write" for r in requests):
            raise ValueError(
                "run_serial replays read-only schedules; use "
                "run_serial_epochs for a read-write schedule"
            )
        return [_exec.execute(r.expr, cache=None) for r in requests]  # rb-ok: epoch-pin -- serial oracle: replays a read-only schedule against a quiesced corpus with no concurrent flips, so there is no epoch to pin

    @staticmethod
    def run_serial_epochs(
        clone_requests: Sequence[Request],
        clone_corpus: Sequence,
        report: "HarnessReport",
    ) -> List[object]:
        """The epoch-replay oracle: replay the concurrent run's
        admitted-epoch schedule serially over a cloned corpus.

        ``clone_requests`` is the same seeded schedule rebuilt over
        ``clone_corpus`` (``build_requests`` is a pure function of the
        seed, so expressions map one to one by position, with the clones
        as leaves; the clone must predate the concurrent run). The oracle
        walks epochs in lineage order: it evaluates every query the run
        admitted under epoch ``e`` against the clone's epoch-``e`` state,
        then applies the lineage record's batches (by the write positions
        that minted them) to advance the clone to ``e + 1``. A concurrent
        result that differs from its position here is a torn read."""
        from ..query import exec as _exec
        from . import ingest as _ingest_mod

        clone_requests = list(clone_requests)
        if len(clone_requests) != len(report.results):
            raise ValueError("oracle schedule does not match the report")
        # batch id -> the clone-schedule position that minted it
        pos_of_batch = {
            bid: pos for pos, bid in enumerate(report.batch_ids) if bid is not None
        }
        by_epoch: Dict[int, List[int]] = {}
        for pos, ep in enumerate(report.epochs):
            if ep is not None:
                by_epoch.setdefault(ep, []).append(pos)
        results: List[object] = [None] * len(clone_requests)
        for pos, bid in enumerate(report.batch_ids):
            if bid is not None:
                results[pos] = ("write", bid)
        epoch = report.epoch_start
        # only flips of this run advance the clone (the lineage ring may
        # hold older records)
        lineage = [
            r for r in report.lineage
            if r.get("outcome") == "flipped" and r["parent"] >= epoch
        ]
        for rec in lineage + [None]:  # None: the final (current) epoch
            for pos in by_epoch.get(epoch, ()):
                results[pos] = _exec.execute(  # rb-ok: epoch-pin -- serial oracle: single-threaded lineage replay on a clone; flips are applied between steps by this loop itself, never concurrently
                    clone_requests[pos].expr, cache=None
                )
            if rec is None:
                break
            for bid in rec["batches"]:
                wpos = pos_of_batch.get(bid)
                if wpos is None:
                    raise ValueError(
                        f"lineage batch {bid} has no write position in the "
                        "schedule (a foreign submit during the run?)"
                    )
                _ingest_mod.apply_batches(
                    clone_corpus,
                    [_ingest_mod.MutationBatch(
                        clone_requests[wpos].tenant, clone_requests[wpos].mutations,
                    )],
                )
            epoch = rec["epoch"]
        return results


class HarnessReport:
    """One run's outcome: per-request results aligned with the schedule,
    per-tenant stats, the aggregate wall and, for epoch-store runs, the
    admitted-epoch schedule (per-position epoch for queries, minted batch
    id for writes) with the lineage the run published — what
    :meth:`LoadHarness.run_serial_epochs` replays."""

    def __init__(self, requests, results, stats, wall_s,
                 epochs=None, batch_ids=None, lineage=None, epoch_start=0,
                 profiles=None):
        self.requests = requests
        self.results = results
        self.stats = stats
        self.wall_s = wall_s
        self.epochs = epochs if epochs is not None else [None] * len(requests)
        self.batch_ids = batch_ids if batch_ids is not None else [None] * len(requests)
        self.lineage = lineage or []
        self.epoch_start = int(epoch_start)
        self.profiles = list(profiles) if profiles is not None else []

    @property
    def served(self) -> int:
        return sum(st.served for st in self.stats.values())

    @property
    def shed(self) -> int:
        return sum(st.shed for st in self.stats.values())

    @property
    def writes(self) -> int:
        return sum(st.writes for st in self.stats.values())

    def aggregate_qps(self) -> float:
        return round(self.served / self.wall_s, 1) if self.wall_s > 0 else 0.0

    def _budget_ms(self, prof: Optional[TenantProfile]) -> Optional[float]:
        if prof is None:
            return None
        if prof.p99_budget_ms is not None:
            return prof.p99_budget_ms
        return _slo.LATENCY_CLASSES[prof.latency_class]

    def tenant_rows(self) -> Dict[str, dict]:
        """Per-tenant decomposition: served / shed / queued volume,
        achieved QPS, and harness-side p50/p99 per phase with the
        end-to-end p99 against the declared budget."""
        by_name = {p.name: p for p in self.profiles}
        out = {}
        for tenant, st in sorted(self.stats.items()):
            prof = by_name.get(tenant)
            budget_ms = self._budget_ms(prof)
            total_p99 = st.total_quantile_ms(0.99)
            out[tenant] = {
                "served": st.served,
                "shed": st.shed,
                "queued": st.queued,
                "writes": st.writes,
                "qps": round(st.served / self.wall_s, 1) if self.wall_s else 0.0,
                "queue_p50_ms": st.quantile_ms("queue", 0.5),
                "queue_p99_ms": st.quantile_ms("queue", 0.99),
                "execute_p50_ms": st.quantile_ms("execute", 0.5),
                "execute_p99_ms": st.quantile_ms("execute", 0.99),
                "latency_class": prof.latency_class if prof else None,
                "p99_budget_ms": budget_ms,
                "total_p99_ms": total_p99,
                "slo_ok": (
                    None if budget_ms is None or total_p99 is None
                    else bool(total_p99 <= budget_ms)
                ),
            }
        return out

    def class_rows(self) -> Dict[str, dict]:
        """Per-latency-class rollup: tenants pooled by their declared
        class, end-to-end p50/p99 over the pooled per-request totals, and
        the tightest budget in the class."""
        pooled: Dict[str, TenantStats] = {}
        budgets: Dict[str, float] = {}
        members: Dict[str, List[str]] = {}
        for p in self.profiles:
            st = self.stats.get(p.name)
            if st is None:
                continue
            agg = pooled.setdefault(p.latency_class, TenantStats())
            agg.served += st.served
            agg.shed += st.shed
            agg.queue_s.extend(st.queue_s)
            agg.execute_s.extend(st.execute_s)
            budget = self._budget_ms(p)
            prev = budgets.get(p.latency_class)
            budgets[p.latency_class] = budget if prev is None else min(prev, budget)
            members.setdefault(p.latency_class, []).append(p.name)
        out = {}
        for cls, agg in sorted(pooled.items()):
            out[cls] = {
                "tenants": sorted(members[cls]),
                "served": agg.served,
                "shed": agg.shed,
                "budget_ms": budgets[cls],
                "p50_ms": agg.total_quantile_ms(0.5),
                "p99_ms": agg.total_quantile_ms(0.99),
            }
        return out
