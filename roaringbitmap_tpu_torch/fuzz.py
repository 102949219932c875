"""Property/invariant fuzzing harness — the reference's ``fuzz-tests`` module
(Fuzzer.verifyInvariance, fuzz-tests/.../Fuzzer.java:31-120;
RandomisedTestData.java:17-52).

Counterpart of ``roaringbitmap_tpu/fuzz.py``, with its generators, family
names, seeds and derating: the same seed draws the same bitmaps, working
sets, mutations, fault schedules and expressions in both packages, and
each family holds this package's engines (its device path on the card,
or on CPU tensors) against its CPU engines and oracles.

``verify_invariance(name, predicate, arity)`` runs the predicate over
randomized shape-diverse bitmaps (rle/dense/sparse chunk mix); on failure the
offending bitmaps are dumped as base64 RoaringFormatSpec payloads so any
failure reproduces from the report alone (the reference's ``Reporter``
behavior). Iteration count comes from ``ROARINGBITMAP_TPU_FUZZ_ITERATIONS``
(the sysprop analogue, RandomisedTestData.java:12).

**The departure.** Where the JAX package degrades a failed device tier to
a CPU tier, this package raises, classified (a device tier is always the
last of its ladder list), and ``columnar.kernel``, ``native.entry`` and
``query.fusion`` raise where the JAX package falls back. The families
that arm fault schedules accept an escaped exception only when it is the
very fault one of their rules injected at a site of
:data:`RAISING_SITES`, classified transient or resource; every result
that does come back must still equal the no-fault oracle, and any other
escape fails as in the JAX package.

The families run on ``parallel.aggregation.config.device`` (and
``models.bsi.config.device``): :func:`run_campaign` sets both for its run
with ``device=``, and ``python -m roaringbitmap_tpu_torch.fuzz [n]
[--device cuda|cpu]`` runs the campaign on the card by default.
"""

from __future__ import annotations

import base64
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .models.roaring import RoaringBitmap

# The fault sites where this package raises, classified, where the JAX
# package degrades to another tier. A device tier is the last of its ladder
# list, so a device fault that outlives its retries raises (store.ship,
# store.hbm, store.expand, ops.dispatch, query.exec, columnar.device);
# columnar.kernel and native.entry raise where the JAX package falls back to
# numpy, and query.fusion where it falls back to per-query execution. The
# fault-schedule families accept an escape only from these sites, and the
# analyzer's fault-site-contract accepts "no ladder route" only for them.
RAISING_SITES: Tuple[str, ...] = (
    "store.ship",
    "store.hbm",
    "store.expand",
    "ops.dispatch",
    "query.exec",
    "query.fusion",
    "columnar.kernel",
    "columnar.device",
    "native.entry",
)


def default_iterations() -> int:
    """Read at call time so late env changes take effect (sysprop analogue).

    Default matches the reference's fuzz intensity
    (RandomisedTestData.java:12 ITERATIONS=10000); the unit suite passes
    explicit small counts, full campaigns run ``python -m
    roaringbitmap_tpu_torch.fuzz``."""
    return int(os.environ.get("ROARINGBITMAP_TPU_FUZZ_ITERATIONS", "10000"))


class InvarianceFailure(AssertionError):
    """Raised with base64 repro payloads when an invariant breaks."""

    def __init__(self, name: str, bitmaps: List[RoaringBitmap], detail: str = ""):
        self.repro = [base64.b64encode(bm.serialize()).decode() for bm in bitmaps]
        msg = (
            f"invariant '{name}' failed{': ' + detail if detail else ''}\n"
            + "\n".join(
                f"  bitmap[{i}] (base64 RoaringFormatSpec): {r}"
                for i, r in enumerate(self.repro)
            )
        )
        super().__init__(msg)


def reproduce(b64: str) -> RoaringBitmap:
    """Rebuild a bitmap from a failure report payload."""
    return RoaringBitmap.deserialize(base64.b64decode(b64))


def _device():
    """The device the families' device steps run on."""
    from .parallel import aggregation

    return aggregation.config.device


def _injected(site: str, exc) -> BaseException:
    """The exception a rule ``(site, exc)`` raises when it fires
    (``robust.faults.FaultRule``)."""
    if callable(exc) and not isinstance(exc, type):
        return exc(site)
    return exc(f"injected fault at site {site!r}")


def _departure(e: BaseException, armed) -> bool:
    """True when ``e`` is the fault that a fired rule of ``armed`` (``(site,
    exc, inject)`` triples) injected at a site of :data:`RAISING_SITES`,
    classified transient or resource: this package's classified raise
    where the JAX package degrades, not a failure."""
    from .robust.errors import RESOURCE, TRANSIENT, classify

    if classify(e) not in (TRANSIENT, RESOURCE):
        return False
    for site, exc, inj in armed:
        if site not in RAISING_SITES or not inj.fired:
            continue
        want = _injected(site, exc)
        if type(e) is type(want) and str(e) == str(want):
            return True
    return False


def _arm(stack, sched) -> list:
    """Enter one ``faults.inject`` scope per schedule rule; returns the
    ``(site, exc, inject)`` triples :func:`_departure` reads."""
    from .robust import faults as rfaults

    return [
        (site, exc, stack.enter_context(rfaults.inject(site, exc, **kw)))
        for site, exc, kw in sched
    ]


def _rle_region(rng) -> np.ndarray:
    starts = rng.choice(np.arange(0, 1 << 16, 64), size=int(rng.integers(1, 30)), replace=False)
    parts = [
        np.arange(s, min(s + int(rng.integers(1, 64)), 1 << 16), dtype=np.int64)
        for s in np.sort(starts)
    ]
    return np.unique(np.concatenate(parts))


def _dense_region(rng) -> np.ndarray:
    return np.sort(rng.choice(1 << 16, size=int(rng.integers(4097, 60000)), replace=False))


def _sparse_region(rng) -> np.ndarray:
    return np.sort(rng.choice(1 << 16, size=int(rng.integers(1, 4096)), replace=False))


def random_bitmap(rng, max_keys: int = 4, optimize_prob: float = 0.3) -> RoaringBitmap:
    """Shape-diverse random bitmap (RandomisedTestData.randomBitmap)."""
    n_keys = int(rng.integers(1, max_keys + 1))
    keys = np.sort(rng.choice(64, size=n_keys, replace=False))
    regions = [_rle_region, _dense_region, _sparse_region]
    parts = [
        regions[int(rng.integers(0, 3))](rng) + (int(k) << 16) for k in keys
    ]
    bm = RoaringBitmap(np.concatenate(parts).astype(np.uint32))
    if rng.random() < optimize_prob:
        bm.run_optimize()
    return bm


def verify_invariance(
    name: str,
    predicate: Callable[..., bool],
    arity: int = 1,
    iterations: Optional[int] = None,
    seed: Optional[int] = None,
    max_keys: int = 4,
) -> None:
    """Run ``predicate(*bitmaps) -> bool`` over random inputs
    (Fuzzer.verifyInvariance, Fuzzer.java:31)."""
    rng = np.random.default_rng(seed)
    for _ in range(iterations or default_iterations()):
        bitmaps = [random_bitmap(rng, max_keys=max_keys) for _ in range(arity)]
        try:
            ok = predicate(*bitmaps)
        except Exception as e:  # predicate crash is also a failure
            raise InvarianceFailure(name, bitmaps, detail=repr(e)) from e
        if not ok:
            raise InvarianceFailure(name, bitmaps)


def verify_buffer_invariance(
    name: str,
    predicate: Callable[..., bool],
    arity: int = 1,
    iterations: Optional[int] = None,
    seed: Optional[int] = None,
) -> None:
    """Buffer-twin fuzzing (BufferFuzzer.java): each random bitmap is
    serialized and handed to the predicate as a zero-copy
    ImmutableRoaringBitmap alongside its heap original —
    ``predicate(mapped..., heap...)``; report payloads reproduce both."""
    from .models.immutable import ImmutableRoaringBitmap

    rng = np.random.default_rng(seed)
    for _ in range(iterations or default_iterations()):
        heap = [random_bitmap(rng) for _ in range(arity)]
        mapped = [ImmutableRoaringBitmap(b.serialize()) for b in heap]
        try:
            ok = predicate(*mapped, *heap)
        except Exception as e:
            raise InvarianceFailure(name, heap, detail=repr(e)) from e
        if not ok:
            raise InvarianceFailure(name, heap)


def random_working_set(rng, layout: str) -> List[RoaringBitmap]:
    """Working set whose key distribution forces a specific device layout
    by construction against store.prepare_reduce's cost model: single
    dense block when its occupancy >= 0.9; count-bucketed ragged batching
    when 3-bucket padding stays <= 1.5x live rows; else the segmented
    scan.

    ``layout='padded'``: every bitmap covers the same few keys — groups
    perfectly balanced, occupancy 1.0. ``layout='bucketed'``: one hot key
    shared by many bitmaps plus many singleton keys — one block would pad
    every singleton group to the hot count (rejected), but 3 buckets pad to
    ~100%. ``layout='segmented-scan'``: a 7-level geometric count pyramid
    (2^j-sized groups, equal mass per level) — every contiguous 3-bucket
    split of a geometric spectrum pays >= 1.86x the live rows (any bucket
    spanning s levels costs ~(2^s - 1)/s per live row), defeating the
    bucket rescue."""
    if layout == "padded":
        keys = np.sort(rng.choice(32, size=int(rng.integers(1, 4)), replace=False))
        out = []
        for _ in range(int(rng.integers(4, 12))):
            parts = [
                _sparse_region(rng) + (int(k) << 16) for k in keys
            ]
            out.append(RoaringBitmap(np.concatenate(parts).astype(np.uint32)))
        return out
    if layout == "bucketed":
        hot = int(rng.integers(0, 8))
        n_hot = int(rng.integers(33, 48))
        n_single = int(rng.integers(64, 90))
        out = [
            RoaringBitmap((_sparse_region(rng) + (hot << 16)).astype(np.uint32))
            for _ in range(n_hot)
        ]
        for j in range(n_single):
            key = 16 + j  # distinct, disjoint from the hot key range
            out.append(
                RoaringBitmap((_sparse_region(rng) + (key << 16)).astype(np.uint32))
            )
        return out
    if layout == "segmented-scan":
        levels = 7
        # group sizes 2^j, 2^(levels-1-j) groups per level; columnar build:
        # bitmap b holds every group whose count exceeds b
        group_counts: List[int] = []
        for j in range(levels):
            group_counts += [2 ** j] * (2 ** (levels - 1 - j))
        n_bitmaps = max(group_counts)
        parts: List[List[np.ndarray]] = [[] for _ in range(n_bitmaps)]
        for key, count in enumerate(group_counts):
            for b in range(count):
                parts[b].append(_sparse_region(rng) + (key << 16))
        return [
            RoaringBitmap(np.concatenate(p).astype(np.uint32)) for p in parts
        ]
    raise ValueError(f"unknown layout {layout}")


def verify_layout_invariance(
    name: str,
    op: str = "or",
    iterations: Optional[int] = None,
    seed: Optional[int] = None,
) -> None:
    """Device-layout fuzzing: for all three layouts — padded, bucketed,
    segmented-scan — (forced by construction, asserted against
    prepare_reduce's actual choice), the device reduction on
    ``aggregation.config.device`` must agree with every CPU engine (naive /
    horizontal / priorityqueue for OR; the reference's cross-engine
    oracle, Fuzzer.java + jmh smoke tests)."""
    from .ops import device as dev
    from .parallel import aggregation, store

    if op not in ("or", "xor"):
        # AND is not per-key decomposable (a key absent from one input
        # annihilates the whole-key result, while the grouped reduce only
        # folds present containers) and other ops have no grouped engine.
        # The AND path (workShy key intersection) is fuzzed via
        # FastAggregation equivalence invariants instead.
        raise ValueError("layout fuzzing supports decomposable ops: 'or', 'xor'")
    rng = np.random.default_rng(seed)
    for i in range(iterations or default_iterations()):
        layout = ("padded", "bucketed", "segmented-scan")[i % 3]
        bms = random_working_set(rng, layout)
        packed = store.pack_groups(store.group_by_key(bms), device=_device())
        run, chosen = store.prepare_reduce(packed, op=op)
        if chosen != layout:
            raise InvarianceFailure(
                name, bms, detail=f"constructed {layout}, dispatcher chose {chosen}"
            )
        red, cards = run()
        got = store.unpack_to_bitmap(
            packed.group_keys, dev.to_host_u32(red), cards.cpu().numpy().astype(np.int64)
        )
        if op == "or":
            oracles = [
                aggregation.FastAggregation.naive_or(*bms),
                aggregation.FastAggregation.horizontal_or(*bms),
                aggregation.FastAggregation.priorityqueue_or(*bms),
            ]
        else:  # "xor" (the guard above admits only or/xor)
            oracles = [aggregation.FastAggregation.naive_xor(*bms)]
        for j, want in enumerate(oracles):
            if got != want:
                raise InvarianceFailure(
                    name, bms, detail=f"{layout} device result != cpu engine {j}"
                )


def _random_mutation(rng, bm: RoaringBitmap) -> None:
    """One random mutation drawn from every family the delta validator must
    classify: in-place container edits (delta rows), key insertions and
    removals (structural -> full repack), and container-form rewrites."""
    kind = int(rng.integers(0, 5))
    hlc = bm.high_low_container
    if kind == 0 and hlc.size:  # point add within an existing chunk
        hb = hlc.keys[int(rng.integers(0, hlc.size))]
        bm.add((int(hb) << 16) | int(rng.integers(0, 1 << 16)))
    elif kind == 1 and not bm.is_empty():  # point remove (may drop the key)
        arr = bm.to_array()
        bm.remove(int(arr[int(rng.integers(0, arr.size))]))
    elif kind == 2:  # brand-new chunk key: structural
        bm.add(int(rng.integers(100, 200)) << 16 | int(rng.integers(0, 1 << 16)))
    elif kind == 3:  # container-form rewrite (set_container_at_index dirty)
        bm.run_optimize()
    else:  # bulk add spanning existing + possibly new chunks
        vals = rng.integers(0, 80 << 16, size=int(rng.integers(1, 64)))
        bm.add_many(vals.astype(np.uint32))


def verify_pack_cache_invariance(
    name: str,
    iterations: Optional[int] = None,
    seed: Optional[int] = None,
) -> None:
    """The resident pack cache differential: across randomized mutation
    sequences, the cache-returned pack on ``aggregation.config.device`` —
    whether exact hit, incremental delta repack, or full rebuild — must
    hold the same keys, offsets and expanded rows as a from-scratch
    ``pack_groups(group_by_key(...))`` of the current bitmaps, on both the
    unfiltered (OR/XOR) and the AND key-intersection layouts. A wrong
    delta classification fails exactly like a wrong kernel."""
    from .ops import device as dev
    from .parallel import store

    device = _device()
    rng = np.random.default_rng(seed)
    for _ in range(iterations or default_iterations()):
        bms = [random_bitmap(rng, max_keys=4) for _ in range(int(rng.integers(2, 6)))]
        cache = store.PackCache(max_bytes=1 << 30)
        for _step in range(int(rng.integers(1, 5))):
            for bi in rng.choice(len(bms), size=int(rng.integers(1, 3)), replace=False):
                _random_mutation(rng, bms[int(bi)])
            keys_filter = None
            if rng.random() < 0.4:
                keys_filter = store.intersect_keys(bms)
                if not keys_filter:
                    continue
            try:
                got = cache.get_packed(bms, keys_filter, device=device)
                want = store.pack_groups(
                    store.group_by_key(bms, keys_filter=keys_filter), device=device
                )
                ok = (
                    np.array_equal(dev.to_host_u32(got.device_words),
                                   dev.to_host_u32(want.device_words))
                    and np.array_equal(got.group_keys, want.group_keys)
                    and np.array_equal(got.group_offsets, want.group_offsets)
                )
            except Exception as e:  # predicate crash is also a failure
                raise InvarianceFailure(name, bms, detail=repr(e)) from e
            if not ok:
                raise InvarianceFailure(
                    name, bms,
                    detail=f"cached pack != fresh pack (filter={keys_filter is not None})",
                )
        cache.close()


def verify_columnar_invariance(
    name: str,
    iterations: Optional[int] = None,
    seed: Optional[int] = None,
) -> None:
    """The columnar pairwise engine differential: under randomized op
    sequences — static and member-semantics (reuse_left) pairwise ops,
    cardinality-only probes, and N-way CPU folds, over shape-diverse
    operands including run-optimized and mapped (buffer) ones — the
    batched engine's result must be value-identical to the per-container
    engine's at every step. Both accumulators then advance with their own
    engine's output, so a divergence compounds and cannot cancel out."""
    from . import columnar
    from .models.immutable import ImmutableRoaringBitmap
    from .models.roaring import RoaringBitmap as RB
    from .parallel import store
    from .parallel.aggregation import FastAggregation as FA

    rng = np.random.default_rng(seed)
    ops = ("and", "or", "xor", "andnot")
    for _ in range(iterations or default_iterations()):
        seed_bm = random_bitmap(rng)
        acc_col, acc_ref = seed_bm.clone(), seed_bm.clone()
        repro = [seed_bm]
        try:
            for _step in range(int(rng.integers(2, 6))):
                b = random_bitmap(rng)
                repro.append(b)
                operand = (
                    ImmutableRoaringBitmap(b.serialize())
                    if rng.random() < 0.3
                    else b
                )
                kind = int(rng.integers(0, 4))
                if kind == 3:  # cardinality-only + intersects probes
                    got_c = columnar.and_cardinality_pair(acc_col, operand)
                    got_i = columnar.intersects_pair(acc_col, operand)
                    with columnar.disabled():
                        want_c = RB.and_cardinality(acc_ref, operand)
                        want_i = RB.intersects(acc_ref, operand)
                    if got_c != want_c or got_i != want_i:
                        raise InvarianceFailure(
                            name, repro, detail=f"card {got_c}!={want_c}"
                        )
                    continue
                op = ops[int(rng.integers(0, 4))]
                # kind 1 = member-op semantics: acc's pass-throughs transfer
                got = columnar.pairwise(op, acc_col, operand, reuse_left=kind == 1)
                with columnar.disabled():
                    want = {
                        "and": RB.and_, "or": RB.or_,
                        "xor": RB.xor, "andnot": RB.andnot,
                    }[op](acc_ref, operand)
                if got != want:
                    raise InvarianceFailure(name, repro, detail=f"op {op}")
                acc_col, acc_ref = got, want
                if rng.random() < 0.3:
                    acc_col.run_optimize()
                    acc_ref.run_optimize()
            # N-way fold step: batched fold vs the naive oracle
            if rng.random() < 0.5:
                bms = [acc_ref] + [random_bitmap(rng) for _ in range(2)]
                groups = store.group_by_key(bms)
                if columnar.fold(groups, "or") != FA.naive_or(*bms):
                    raise InvarianceFailure(name, repro, detail="fold or")
        except InvarianceFailure:
            raise
        except Exception as e:  # engine crash is also a failure
            raise InvarianceFailure(name, repro, detail=repr(e)) from e


def random_fault_schedule(rng) -> list:
    """1-3 random fault rules over random registered sites: error kind
    drawn from the taxonomy (transient / resource / simulated device OOM),
    trigger drawn from every=/after=/prob= (seeded)."""
    from .robust import faults as rfaults
    from .robust.errors import ResourceExhausted, TransientDeviceError, simulated_oom

    rules = []
    for _ in range(int(rng.integers(1, 4))):
        site = rfaults.SITES[int(rng.integers(0, len(rfaults.SITES)))]
        exc = (TransientDeviceError, ResourceExhausted, simulated_oom)[
            int(rng.integers(0, 3))
        ]
        kind = int(rng.integers(0, 3))
        kw: dict = {}
        if kind == 0:
            kw["every"] = int(rng.integers(1, 4))
        elif kind == 1:
            kw["after"] = int(rng.integers(0, 3))
        else:
            kw["prob"] = float(rng.uniform(0.1, 0.9))
            kw["seed"] = int(rng.integers(0, 1 << 16))
        rules.append((site, exc, kw))
    return rules


def verify_fault_schedule_invariance(
    name: str,
    iterations: Optional[int] = None,
    seed: Optional[int] = None,
) -> None:
    """Random op/query sequences under random seeded fault schedules must
    be bit-exact with the no-fault oracle (computed mid-schedule inside
    ``faults.suspended()``). A step may raise only the fault a rule
    injected at a site of :data:`RAISING_SITES` (the port's classified
    raise where the JAX package degrades); a fault that corrupts a
    result, a tier that isn't bit-exact, and any other escaped exception
    all fail identically."""
    from contextlib import ExitStack

    from .models.roaring import RoaringBitmap as RB
    from .parallel import store
    from .parallel.aggregation import FastAggregation as FA
    from .query import evaluate_naive, execute
    from .robust import faults as rfaults
    from .robust import ladder as rladder
    from .robust.errors import FATAL, classify

    rng = np.random.default_rng(seed)
    for _ in range(iterations or default_iterations()):
        bms = [random_bitmap(rng) for _ in range(int(rng.integers(2, 5)))]
        sched = random_fault_schedule(rng)
        rfaults.clear()  # fresh per-site hit counters: schedules replay
        rladder.LADDER.reset()
        store.PACK_CACHE.close()
        try:
            with ExitStack() as stack:
                armed = _arm(stack, sched)
                for _step in range(int(rng.integers(1, 4))):
                    kind = int(rng.integers(0, 4))
                    if kind == 0:  # N-way aggregation, any dispatch mode
                        mode = ("cpu", "device", None)[int(rng.integers(0, 3))]
                        op = ("or_", "and_", "xor")[int(rng.integers(0, 3))]
                        step = lambda: getattr(FA, op)(*bms, mode=mode)
                        oracle = lambda: getattr(FA, op)(*bms, mode="cpu")
                    elif kind == 1:  # pairwise facade (columnar router)
                        step = lambda: RB.and_(bms[0], bms[1])
                        oracle = step
                    elif kind == 2:  # n-way andnot kernel, device-routed
                        step = lambda: FA.andnot(bms[0], *bms[1:], mode="device")
                        oracle = lambda: FA.andnot(bms[0], *bms[1:], mode="cpu")
                    else:  # full query DAG, sometimes deadline-cancelled
                        expr = random_expression(rng, bms, max_depth=3)
                        deadline = (None, 0.0)[int(rng.integers(0, 2))]
                        step = lambda: execute(expr, cache=None, deadline_s=deadline)
                        oracle = lambda: evaluate_naive(expr)
                    try:
                        got = step()
                    except Exception as e:
                        if classify(e) == FATAL or not _departure(e, armed):
                            raise
                        continue  # the port's classified raise: nothing came back
                    with rfaults.suspended():
                        want = oracle()
                    if got != want:
                        raise InvarianceFailure(
                            name, bms,
                            detail=f"fault-schedule result diverged "
                            f"(step kind={kind}, schedule={sched})",
                        )
        except InvarianceFailure:
            raise
        except Exception as e:  # rb-ok: exception-hygiene -- the family's whole point: ANY escape the departure table does not cover is a failure, re-wrapped with the repro schedule
            raise InvarianceFailure(
                name, bms,
                detail=f"exception escaped the ladder: {e!r} (schedule={sched})",
            ) from e
        finally:
            rfaults.clear()


def verify_fusion_invariance(
    name: str,
    iterations: Optional[int] = None,
    seed: Optional[int] = None,
    faults_prob: float = 0.25,
) -> None:
    """Random OVERLAPPING expression sets executed through the fusion
    window must be bit-exact with the serial per-query oracle. Overlap is
    constructed two ways each iteration — a shared random subexpression
    grafted under several queries' roots (the hash-consed DAG makes it ONE
    node across plans, exercising the window dedup), and duplicate whole
    queries (exercising the in-flight join). Every other iteration arms a
    random seeded fault schedule drawn over the registered sites; a fault
    at ``query.fusion`` or on a device step raises, classified (the
    departure), and anything else must leave the window's results
    bit-exact. The oracle is computed mid-schedule inside
    ``faults.suspended()`` with the serial executor.

    Mixed latency classes: each iteration ALSO drives the same query set
    through a live :class:`FusionExecutor` with alternating
    ``interactive``/``batch`` slack declarations, so the SLO-priced submit
    path — deadline-aware window close, the ``fusion.hedge`` verdict, and
    hedged solo dispatch through the in-flight table (fault site
    ``"query.hedge"``, which degrades back to the window rung
    bit-exactly) — is fuzzed under the same schedules as the plain batch
    entry."""
    from contextlib import ExitStack

    from .query import Q, ResultCache, execute, fusion
    from .robust import faults as rfaults
    from .robust import ladder as rladder
    from .robust.errors import FATAL, classify

    rng = np.random.default_rng(seed)
    for it in range(iterations or default_iterations()):
        bms = [random_bitmap(rng) for _ in range(int(rng.integers(3, 6)))]
        shared = random_expression(rng, bms, max_depth=2)
        queries = []
        for _ in range(int(rng.integers(2, 6))):
            own = random_expression(rng, bms, max_depth=2)
            kind = int(rng.integers(0, 3))
            if kind == 0:
                queries.append(Q.or_(shared, own))
            elif kind == 1:
                queries.append(Q.andnot(own, shared))
            else:
                queries.append(own)
        if len(queries) > 2 and rng.random() < 0.5:
            queries.append(queries[int(rng.integers(0, len(queries)))])
        sched = random_fault_schedule(rng) if it % 2 else []
        rfaults.clear()
        rladder.LADDER.reset()
        try:
            with ExitStack() as stack:
                armed = _arm(stack, sched)
                with rfaults.suspended():
                    want = [execute(q, cache=None) for q in queries]
                try:
                    got = fusion.execute_fused(
                        queries, cache=ResultCache(max_entries=64)
                    )
                except Exception as e:
                    if classify(e) == FATAL or not _departure(e, armed):
                        raise
                    got = [None] * len(queries)  # the window raised: nothing came back
                for gi, (g, w) in enumerate(zip(got, want)):
                    if g is not None and g != w:
                        raise InvarianceFailure(
                            name, bms,
                            detail=f"fused query {gi} diverged from the "
                            f"serial oracle (schedule={sched})",
                        )
                # the SLO-priced submit path under the same schedule:
                # alternating latency classes, tight interactive slack so
                # the hedge verdict actually fires solo dispatches
                with fusion.FusionExecutor(
                    cache=ResultCache(max_entries=64)
                ) as execu:
                    futs = [
                        execu.submit(
                            q,
                            slack_ms=(5.0, 1000.0)[qi % 2],
                            latency_class=("interactive", "batch")[qi % 2],
                        )
                        for qi, q in enumerate(queries)
                    ]
                    hedged = []
                    for f in futs:
                        try:
                            hedged.append(f.result())
                        except Exception as e:
                            if classify(e) == FATAL or not _departure(e, armed):
                                raise
                            hedged.append(None)
                for gi, (g, w) in enumerate(zip(hedged, want)):
                    if g is not None and g != w:
                        raise InvarianceFailure(
                            name, bms,
                            detail=f"SLO-priced submit query {gi} diverged "
                            f"from the serial oracle (schedule={sched})",
                        )
        except InvarianceFailure:
            raise
        except Exception as e:  # rb-ok: exception-hygiene -- the family's whole point: ANY escape the departure table does not cover is a failure, re-wrapped with the repro schedule
            raise InvarianceFailure(
                name, bms,
                detail=f"exception escaped the fusion ladder: {e!r} "
                f"(schedule={sched})",
            ) from e
        finally:
            rfaults.clear()


def verify_serve_invariance(
    name: str,
    iterations: Optional[int] = None,
    seed: Optional[int] = None,
) -> None:
    """Seeded multi-tenant traffic through the serving harness (admission
    -> fusion window, 2-4 worker threads) must be bit-exact with the same
    query multiset executed serially — the request schedule is a pure
    function of the seed, so the serial oracle replays the exact multiset
    the concurrent run served. Quotas are generous (no shed): every
    request must produce a result identical to ``execute(q, cache=None)``
    computed inside ``faults.suspended()``. Every other iteration arms a
    random seeded fault schedule over the registered sites INCLUDING
    ``serve.admit`` (which must fail OPEN — admission is load management,
    never a correctness gate); a run that raises the fault a rule injected
    at a site of :data:`RAISING_SITES` is the departure. A stale
    cross-request publication, a fault that drops or corrupts a request,
    and any other escaped exception all fail identically, with the
    schedule in the repro detail."""
    from contextlib import ExitStack

    from .robust import faults as rfaults
    from .robust import ladder as rladder
    from .robust.errors import FATAL, classify
    from .serve import (
        AdmissionController, LoadHarness, TenantProfile, build_requests,
    )
    from .serve import slo as sslo

    rng = np.random.default_rng(seed)
    for it in range(iterations or default_iterations()):
        bms = [random_bitmap(rng) for _ in range(int(rng.integers(4, 7)))]
        n_tenants = int(rng.integers(2, 4))
        profiles = [
            TenantProfile(
                f"fz-t{i}", weight=float(rng.uniform(0.5, 2.0)),
                quota_qps=1e6, burst=1e6,
            )
            for i in range(n_tenants)
        ]
        sched = random_fault_schedule(rng) if it % 2 else []
        rfaults.clear()
        rladder.LADDER.reset()
        sslo.reset()
        try:
            harness = LoadHarness(
                bms, profiles,
                threads=int(rng.integers(2, 5)),
                window=int(rng.integers(2, 6)),
                admission=AdmissionController(
                    max_inflight=int(rng.integers(1, 9)), queue_limit=64
                ),
            )
            requests = build_requests(
                bms, profiles, int(rng.integers(4, 13)),
                seed=int(rng.integers(0, 1 << 16)),
            )
            with ExitStack() as stack:
                armed = _arm(stack, sched)
                with rfaults.suspended():
                    want = harness.run_serial(requests)
                try:
                    results = harness.run(requests).results
                except Exception as e:
                    if classify(e) == FATAL or not _departure(e, armed):
                        raise
                    results = []  # the run raised the departure: nothing came back
                for gi, (g, w) in enumerate(zip(results, want)):
                    if g != w:
                        raise InvarianceFailure(
                            name, bms,
                            detail=f"served request {gi} diverged from the "
                            f"serial oracle (schedule={sched})",
                        )
        except InvarianceFailure:
            raise
        except Exception as e:  # rb-ok: exception-hygiene -- the family's whole point: ANY escape the departure table does not cover is a failure, re-wrapped with the repro schedule
            raise InvarianceFailure(
                name, bms,
                detail=f"exception escaped the serving harness: {e!r} "
                f"(schedule={sched})",
            ) from e
        finally:
            rfaults.clear()
            sslo.reset()


def verify_epoch_invariance(
    name: str,
    iterations: Optional[int] = None,
    seed: Optional[int] = None,
) -> None:
    """Threaded queries under CONCURRENT ingest + epoch flips must each be
    bit-exact with the snapshot of the epoch they were admitted under —
    zero torn reads. Each iteration runs query threads (each pinning an
    epoch via ``EpochStore.reader`` and executing a seeded random DAG)
    against a writer thread submitting stamped mutation batches and
    forcing flips; every other iteration arms a random seeded fault
    schedule over the registered sites INCLUDING ``epoch.flip`` (which
    must fail CLOSED to the old epoch — an aborted flip leaves readers on
    a stale but consistent snapshot, never a torn one). The oracle replays
    the published lineage over a pre-run clone: epoch state k+1 = state k
    + the lineage record's batches, and each query's result must equal its
    admitted epoch's state (the expression is rebuilt over the clone from
    the query's own seed). A thread that raises the fault a rule injected
    at a site of :data:`RAISING_SITES` is the departure; a result matching
    neither snapshot, a flip that tears a reader, and any other escaped
    exception all fail identically, with the schedule in the repro
    detail."""
    import threading
    from contextlib import ExitStack

    from .query import exec as qexec
    from .robust import faults as rfaults
    from .robust import ladder as rladder
    from .robust.errors import FATAL, classify
    from .serve import ingest as singest
    from .serve import slo as sslo
    from .serve.epochs import EpochStore

    rng = np.random.default_rng(seed)
    for it in range(iterations or default_iterations()):
        n_bms = int(rng.integers(4, 7))
        bms = [random_bitmap(rng) for _ in range(n_bms)]
        clone = [b.clone() for b in bms]
        n_queries = int(rng.integers(3, 8))
        q_seeds = [int(rng.integers(0, 1 << 16)) for _ in range(n_queries)]
        exprs = [
            random_expression(np.random.default_rng(s), bms, max_depth=3)
            for s in q_seeds
        ]
        write_muts = [
            {
                int(rng.integers(0, n_bms)): rng.integers(
                    0, 1 << 18, size=int(rng.integers(1, 16))
                )
            }
            for _ in range(int(rng.integers(1, 4)))
        ]
        sched = random_fault_schedule(rng) if it % 2 else []
        rfaults.clear()
        rladder.LADDER.reset()
        sslo.reset()
        sslo.TENANTS.declare("fz-writer", quota_qps=1e6, burst=1e6)
        es = EpochStore(bms)
        results: List[Optional[tuple]] = [None] * n_queries
        submitted = {}
        # (query index or None for the writer, exception)
        errors: List[Tuple[Optional[int], BaseException]] = []

        def _query(qi):
            try:
                with es.reader() as tk:
                    results[qi] = (tk.epoch, qexec.execute(exprs[qi], cache=None))
            except BaseException as e:  # rb-ok: exception-hygiene -- the family's whole point: ANY escape past the epoch machinery/ladder is judged below, against the departure table, and re-wrapped with the repro schedule
                errors.append((qi, e))

        def _writer():
            try:
                for muts in write_muts:
                    b = es.submit("fz-writer", muts)
                    if b is not None:
                        submitted[b.batch_id] = b
                    es.flip(reason="fuzz")
            except BaseException as e:  # rb-ok: exception-hygiene -- same re-wrap contract as the query workers
                errors.append((None, e))

        threads = [
            threading.Thread(target=_query, args=(qi,), daemon=True)
            for qi in range(n_queries)
        ] + [threading.Thread(target=_writer, daemon=True)]
        try:
            with ExitStack() as stack:
                armed = _arm(stack, sched)
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
            departed = set()
            for who, e in errors:
                if not (
                    isinstance(e, Exception)
                    and classify(e) != FATAL
                    and _departure(e, armed)
                ):
                    raise e
                departed.add(who)
            # the lineage replay: epoch state k+1 = state k + the
            # record's batches, applied to a pre-run clone
            states = {0: clone}
            cur = clone
            for rec in (r for r in es.lineage() if r["outcome"] == "flipped"):
                cur = [b.clone() for b in cur]
                singest.apply_batches(
                    cur, [submitted[bid] for bid in rec["batches"]]
                )
                states[rec["epoch"]] = cur
            with rfaults.suspended():
                for qi, r in enumerate(results):
                    if r is None:
                        if qi in departed:
                            continue  # raised the departure: nothing came back
                        raise InvarianceFailure(
                            name, bms,
                            detail=f"query {qi} produced no result and no "
                            f"error (schedule={sched})",
                        )
                    ep, got = r
                    snap = states.get(ep)
                    if snap is None:
                        raise InvarianceFailure(
                            name, bms,
                            detail=f"query {qi} admitted under unpublished "
                            f"epoch {ep} (schedule={sched})",
                        )
                    want = qexec.execute(
                        random_expression(
                            np.random.default_rng(q_seeds[qi]), snap,
                            max_depth=3,
                        ),
                        cache=None,
                    )
                    if got != want:
                        raise InvarianceFailure(
                            name, bms,
                            detail=f"TORN READ: query {qi} under epoch {ep} "
                            f"matches no legal snapshot (schedule={sched})",
                        )
        except InvarianceFailure:
            raise
        except Exception as e:  # rb-ok: exception-hygiene -- the family's whole point: ANY escape the departure table does not cover is a failure, re-wrapped with the repro schedule
            raise InvarianceFailure(
                name, bms,
                detail=f"exception escaped the epoch machinery: {e!r} "
                f"(schedule={sched})",
            ) from e
        finally:
            rfaults.clear()
            sslo.reset()


def verify_compaction_invariance(
    name: str,
    iterations: Optional[int] = None,
    seed: Optional[int] = None,
) -> None:
    """Background compaction may change *representation*, never *content*.
    Each iteration drives a random ingest sequence (mixing scatter batches
    with run-friendly contiguous ranges, so ``run_optimize`` has real
    rewrites to make) through an ``EpochStore`` with FORCED maintenance
    passes interleaved between flips; every other iteration arms a random
    seeded fault schedule biased to include the ``serve.maintain`` site
    (which must fail CLOSED — an aborted pass leaves the uncompacted epoch
    serving exactly the bits it had). The oracle is a no-compaction twin:
    the pre-run clone plus every published lineage record's batches, with
    every fault suspended — the live corpus must equal the twin
    bit-exactly, and the passes' own bit-identity audits must report zero
    anomalies (a nonzero count means ``run_optimize`` changed bits and
    only the audit saved the corpus). A pass that raises the fault a rule
    injected at a site of :data:`RAISING_SITES` is the departure."""
    from contextlib import ExitStack

    from .observe import structure as ostructure
    from .robust import faults as rfaults
    from .robust import ladder as rladder
    from .robust.errors import FATAL, TransientDeviceError, classify
    from .serve import ingest as singest
    from .serve import maintain as smaintain
    from .serve import slo as sslo
    from .serve.epochs import EpochStore

    rng = np.random.default_rng(seed)
    for it in range(iterations or default_iterations()):
        n_bms = int(rng.integers(3, 6))
        bms = [random_bitmap(rng) for _ in range(n_bms)]
        clone = [b.clone() for b in bms]
        write_muts = []
        for _ in range(int(rng.integers(2, 6))):
            muts: dict = {}
            for _ in range(int(rng.integers(1, 3))):
                tgt = int(rng.integers(0, n_bms))
                if rng.random() < 0.5:
                    # a contiguous run so format re-selection has work
                    start = int(rng.integers(0, 1 << 17))
                    vals = np.arange(start, start + int(rng.integers(64, 2048)))
                else:
                    vals = rng.integers(0, 1 << 18, size=int(rng.integers(1, 32)))
                muts[tgt] = np.union1d(
                    muts.get(tgt, np.empty(0, np.int64)), vals
                )
            write_muts.append(muts)
        sched = random_fault_schedule(rng) if it % 2 else []
        if sched and rng.random() < 0.7:
            # bias toward the site under test: the pass entry's fail-closed
            # gate is the family's whole point
            sched.append(
                ("serve.maintain", TransientDeviceError,
                 {"prob": float(rng.uniform(0.2, 0.9)),
                  "seed": int(rng.integers(0, 1 << 16))})
            )
        rfaults.clear()
        rladder.LADDER.reset()
        sslo.reset()
        sslo.TENANTS.declare("fz-writer", quota_qps=1e6, burst=1e6)
        ostructure.LEDGER.reset()
        smaintain.reset()
        es = EpochStore(bms)
        ostructure.LEDGER.watch("fz-compact", bms)
        submitted = {}
        anomalies = 0
        try:
            with ExitStack() as stack:
                armed = _arm(stack, sched)
                for muts in write_muts:
                    try:
                        b = es.submit("fz-writer", muts)
                    except Exception:  # rb-ok: exception-hygiene -- an injected fault at submit leaves the batch unsubmitted; the twin replays only PUBLISHED lineage, so a lost batch stays consistent
                        b = None
                    if b is not None:
                        submitted[b.batch_id] = b
                    try:
                        es.flip(reason="fuzz")
                    except Exception:  # rb-ok: exception-hygiene -- an aborted flip (an injected fault) keeps the old epoch; the lineage replay below only sees published flips
                        pass
                    try:
                        rec = smaintain.run_pass(
                            store=es, reason="fuzz", force=True,
                        )
                    except Exception as e:
                        if classify(e) == FATAL or not _departure(e, armed):
                            raise
                        continue  # the pass raised the departure: no audit came back
                    anomalies += int(rec.get("anomalies") or 0)
            # the no-compaction twin: pre-run clone + every PUBLISHED
            # record's batches, faults suspended (invisible to schedules)
            with rfaults.suspended():
                twin = [b.clone() for b in clone]
                for rec in (
                    r for r in es.lineage() if r["outcome"] == "flipped"
                ):
                    singest.apply_batches(
                        twin, [submitted[bid] for bid in rec["batches"]]
                    )
                if anomalies:
                    raise InvarianceFailure(
                        name, bms,
                        detail=f"bit-identity audit caught {anomalies} lossy "
                        f"rewrite(s): run_optimize changed content "
                        f"(schedule={sched})",
                    )
                for i, (got, want) in enumerate(zip(es.corpus, twin)):
                    if got != want:
                        raise InvarianceFailure(
                            name, bms,
                            detail=f"compacted corpus[{i}] diverged from the "
                            f"no-compaction twin (schedule={sched})",
                        )
        except InvarianceFailure:
            raise
        except Exception as e:  # rb-ok: exception-hygiene -- the family's whole point: ANY escape the departure table does not cover is a failure, re-wrapped with the repro schedule
            raise InvarianceFailure(
                name, bms,
                detail=f"exception escaped the maintenance tier: {e!r} "
                f"(schedule={sched})",
            ) from e
        finally:
            rfaults.clear()
            sslo.reset()
            ostructure.LEDGER.reset()
            smaintain.reset()


def _durable_plan(plan_seed: int):
    """The seeded deterministic workload the crash family replays on BOTH
    sides of the process boundary: the parent derives the oracle from the
    same plan the (killed) child executed, so nothing needs to survive
    the crash except the durable artifacts under test."""
    rng = np.random.default_rng(plan_seed)
    bms = [random_bitmap(rng) for _ in range(int(rng.integers(3, 6)))]
    muts = [
        {
            int(rng.integers(0, len(bms))): rng.integers(
                0, 1 << 18, size=int(rng.integers(1, 16))
            )
        }
        for _ in range(int(rng.integers(2, 5)))
    ]
    return bms, muts


def _durable_child(root: str, plan_seed: int, kill_hit: int, device: str) -> None:
    """The crash family's subprocess body: replay the seeded plan (one
    submit + one flip per batch, every flip force-persisted) with its
    device steps on ``device`` and die WITHOUT UNWINDING at the
    ``kill_hit``-th ``durable.persist`` crash point — a simulated power
    cut at exactly that persist stage (``os._exit`` from the injected
    exception's constructor, which ``faults.inject`` builds at the firing
    hit, so no ``finally`` blocks, no fsyncs, no atexit handlers run).
    ``kill_hit=0`` runs to completion. Prints ``PERSISTED <epoch>`` after
    each completed persist; the parent's recovery floor."""
    import contextlib
    import os as _os

    from .durable import DurableStore
    from .models import bsi as _bsi
    from .parallel import aggregation as _agg
    from .robust import faults as rfaults
    from .serve import slo as sslo
    from .serve.epochs import EpochStore

    class _PowerCut(BaseException):
        def __init__(self, *args):
            _os._exit(137)

    _agg.config.device = _bsi.config.device = device
    bms, muts = _durable_plan(plan_seed)
    sslo.TENANTS.declare("fz-durable", quota_qps=1e6, burst=1e6)
    es = EpochStore(bms)
    ds = DurableStore(root)
    ctx = (
        rfaults.inject("durable.persist", _PowerCut, after=kill_hit - 1)
        if kill_hit
        else contextlib.nullcontext()
    )
    with ctx:
        for m in muts:
            es.submit("fz-durable", m)
            es.flip(reason="fuzz-durable")
            # persist() directly (not the priced maybe_persist) so the
            # crash-point schedule is deterministic: exactly 5 hits per
            # flip, and the chosen kill_hit lands in a known stage
            ds.persist(es, reason="fuzz-durable")
            print(f"PERSISTED {es.current()}", flush=True)


def verify_durable_crash_invariance(
    name: str,
    iterations: Optional[int] = None,
    seed: Optional[int] = None,
) -> None:
    """A process killed at ANY persist crash point must recover bit-exactly
    to the last PUBLISHED epoch — never a torn one, never an older one than
    a persist that completed. Each iteration spawns a fresh interpreter
    replaying a seeded plan (:func:`_durable_plan`) on this process's
    ``aggregation.config.device``, passed as an argument, whose persist is
    killed without unwinding at a random ``durable.persist`` hit
    (``os._exit`` mid-stage; hit 0 is the clean control run). The child is
    a new interpreter (no fork of a process that holds a CUDA context),
    and it runs while this process waits, so the two never build kernels
    into ``_build/`` at once. The parent then recovers from the child's
    root and checks, against the deterministic replay oracle (epoch *k* =
    seed corpus + the first *k* mutation batches):

    * recovery epoch >= every epoch the child logged as persisted
      (durability floor: a completed persist survives the crash), and
      <= the plan's flip count (no invented epochs);
    * the recovered mapped corpus is bit-exact with the oracle replay at
      the recovered epoch (zero torn artifacts served);
    * a clean child (kill_hit 0) exits 0 and recovers its final epoch."""
    import shutil
    import subprocess
    import sys as _sys
    import tempfile

    from .durable import recover as _drecover
    from .serve import ingest as singest

    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    child_code = (
        "import sys; from roaringbitmap_tpu_torch.fuzz import _durable_child; "
        "_durable_child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])"
    )
    device = str(_device())
    rng = np.random.default_rng(seed)
    for it in range(iterations or default_iterations()):
        plan_seed = int(rng.integers(0, 1 << 16))
        bms, muts = _durable_plan(plan_seed)
        n_flips = len(muts)
        # 5 crash points per persist call x one persist per flip; 0 = the
        # clean control run (child must then exit 0 with the final epoch)
        kill_hit = int(rng.integers(0, 5 * n_flips + 1))
        root = tempfile.mkdtemp(prefix="fz_durable_")
        try:
            env = dict(os.environ)
            env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
            proc = subprocess.run(
                [_sys.executable, "-c", child_code,
                 root, str(plan_seed), str(kill_hit), device],
                capture_output=True, text=True, env=env, timeout=300,
            )
            logged = [
                int(line.split()[1])
                for line in proc.stdout.splitlines()
                if line.startswith("PERSISTED ")
            ]
            if kill_hit == 0 and proc.returncode != 0:
                raise InvarianceFailure(
                    name, bms,
                    detail=f"clean child (seed={plan_seed}) exited "
                    f"{proc.returncode}: {proc.stderr[-500:]}",
                )
            last_logged = max(logged) if logged else 0
            rec = _drecover(root)
            if rec is None:
                if last_logged:
                    raise InvarianceFailure(
                        name, bms,
                        detail=f"DURABILITY LOST: child persisted epoch "
                        f"{last_logged} (seed={plan_seed}, "
                        f"kill_hit={kill_hit}) but recovery found nothing",
                    )
                continue  # killed before the first publish: legal
            if not last_logged <= rec.epoch <= n_flips:
                raise InvarianceFailure(
                    name, bms,
                    detail=f"recovered epoch {rec.epoch} outside "
                    f"[{last_logged}, {n_flips}] (seed={plan_seed}, "
                    f"kill_hit={kill_hit})",
                )
            oracle = [b.clone() for b in bms]
            singest.apply_batches(
                oracle,
                [singest.MutationBatch("fz-durable", m)
                 for m in muts[: rec.epoch]],
            )
            got = rec.corpus.bitmaps()
            torn = len(got) != len(oracle) or any(
                g.to_mutable() != w for g, w in zip(got, oracle)
            )
            # release the zero-copy views before closing the map (close
            # fails loudly while exported buffers are alive — by design)
            del got
            if torn:
                raise InvarianceFailure(
                    name, bms,
                    detail=f"TORN EPOCH: recovered corpus at epoch "
                    f"{rec.epoch} is not bit-exact with the replay oracle "
                    f"(seed={plan_seed}, kill_hit={kill_hit})",
                )
            if kill_hit == 0 and rec.epoch != n_flips:
                raise InvarianceFailure(
                    name, bms,
                    detail=f"clean run recovered epoch {rec.epoch}, "
                    f"wanted the final epoch {n_flips} (seed={plan_seed})",
                )
            rec.corpus.close()
        finally:
            shutil.rmtree(root, ignore_errors=True)


def random_expression(rng, leaves: List[RoaringBitmap], max_depth: int = 4):
    """Random query DAG over the given leaf bitmaps: every node kind
    (and/or/xor/n-ary andnot/not-over-explicit-universe/threshold), biased
    toward reusing leaves so hash-consing and CSE paths are exercised. The
    universe for ``not`` is the union of all leaves (a realistic "all
    users" set)."""
    from .query import Q

    universe = Q.or_(*[Q.leaf(b) for b in leaves]) if len(leaves) > 1 else Q.leaf(leaves[0])

    def build(depth: int):
        if depth >= max_depth or rng.random() < 0.3:
            return Q.leaf(leaves[int(rng.integers(0, len(leaves)))])
        kind = int(rng.integers(0, 6))
        n = int(rng.integers(2, 5))
        subs = [build(depth + 1) for _ in range(n)]
        if kind == 0:
            return Q.and_(*subs)
        if kind == 1:
            return Q.or_(*subs)
        if kind == 2:
            return Q.xor(*subs)
        if kind == 3:
            return Q.andnot(subs[0], *subs[1:])
        if kind == 4:
            return Q.not_(subs[0], universe)
        # k spans the interesting range including k == n and k > n
        return Q.threshold(int(rng.integers(1, n + 2)), *subs)

    return build(0)


def verify_query_invariance(
    name: str,
    iterations: Optional[int] = None,
    seed: Optional[int] = None,
    mode: Optional[str] = None,
) -> None:
    """The query-engine differential invariant: for every sampled DAG,
    planner + executor output must equal naive recursive set-algebra
    evaluation (query.evaluate_naive). Runs with a small shared result
    cache so memoization and eviction are under test too — an execution
    served from a stale cache entry fails exactly like a wrong engine."""
    from .query import ResultCache, evaluate_naive, execute

    rng = np.random.default_rng(seed)
    cache = ResultCache(max_entries=32)
    for _ in range(iterations or default_iterations()):
        leaves = [random_bitmap(rng) for _ in range(int(rng.integers(2, 5)))]
        expr = random_expression(rng, leaves)
        try:
            got = execute(expr, cache=cache, mode=mode)
            want = evaluate_naive(expr)
            ok = got == want
        except Exception as e:
            raise InvarianceFailure(name, leaves, detail=f"{expr!r}: {e!r}") from e
        if not ok:
            raise InvarianceFailure(name, leaves, detail=repr(expr))


def random_bitmap64(rng, max_buckets: int = 3):
    """Shape-diverse 64-bit bitmap spanning several high-32 buckets."""
    from .models.roaring64 import Roaring64NavigableMap

    out = Roaring64NavigableMap()
    buckets = rng.choice(1 << 12, size=int(rng.integers(1, max_buckets + 1)), replace=False)
    for b in buckets:
        vals = random_bitmap(rng, max_keys=2).to_array().astype(np.uint64)
        out.add_many(vals | (np.uint64(int(b)) << np.uint64(32)))
    return out


def verify_invariance64(
    name: str,
    predicate: Callable[..., bool],
    arity: int = 1,
    iterations: Optional[int] = None,
    seed: Optional[int] = None,
) -> None:
    """64-bit fuzzing over both designs: the predicate gets
    Roaring64NavigableMap inputs; equivalence with the ART design is
    itself a good invariant (cross-implementation oracle, SURVEY §4)."""
    rng = np.random.default_rng(seed)
    for _ in range(iterations or default_iterations()):
        bitmaps = [random_bitmap64(rng) for _ in range(arity)]
        # InvarianceFailure only needs .serialize(), which the 64-bit
        # facades provide — repro payloads are portable-64 bytes
        try:
            ok = predicate(*bitmaps)
        except Exception as e:
            raise InvarianceFailure(name, bitmaps, detail=repr(e)) from e
        if not ok:
            raise InvarianceFailure(name, bitmaps)


def run_campaign(
    iterations: Optional[int] = None,
    verbose: bool = True,
    device=None,
    walls: Optional[Dict[str, float]] = None,
) -> dict:
    """Full fuzz campaign at reference intensity (``python -m
    roaringbitmap_tpu_torch.fuzz``; Fuzzer.java's invariant suite, default
    10k iterations per invariant). Returns {invariant: iterations_run}.

    ``device`` (``"cuda"`` / ``"cpu"``), when given, is set as
    ``aggregation.config.device`` and ``bsi.config.device`` for the run and
    restored after; ``"cuda"`` without a card raises ``TierUnavailable``.
    ``walls``, when given, receives each family's wall seconds."""
    from .device import resolve_device
    from .models import bsi as _bsi
    from .parallel import aggregation as _agg

    saved = (_agg.config.device, _bsi.config.device)
    if device is not None:
        resolve_device(device)
        _agg.config.device = _bsi.config.device = str(device)
    try:
        return _campaign(iterations, verbose, walls)
    finally:
        _agg.config.device, _bsi.config.device = saved


def _campaign(iterations, verbose, walls) -> dict:
    import time

    from .models.roaring import RoaringBitmap as RB
    from .parallel.aggregation import FastAggregation as FA

    n = iterations or default_iterations()
    results = {}

    def _run(name, fn, actual=None):
        ran = actual if actual is not None else n
        t0 = time.time()
        fn()
        wall = time.time() - t0
        results[name] = ran
        if walls is not None:
            walls[name] = wall
        if verbose:
            print(f"  {name}: {ran} iterations ok ({wall:.1f}s)", flush=True)

    _run(
        "and-distributes-over-or",
        lambda: verify_invariance(
            "and-distributes-over-or",
            lambda a, b, c: RB.and_(a, RB.or_(b, c))
            == RB.or_(RB.and_(a, b), RB.and_(a, c)),
            arity=3, iterations=n, seed=1,
        ),
    )
    _run(
        "xor-involution",
        lambda: verify_invariance(
            "xor-involution",
            lambda a, b: RB.xor(RB.xor(a, b), b) == a,
            arity=2, iterations=n, seed=2,
        ),
    )
    _run(
        "inclusion-exclusion",
        lambda: verify_invariance(
            "inclusion-exclusion",
            lambda a, b: RB.or_cardinality(a, b)
            == a.get_cardinality() + b.get_cardinality() - RB.and_cardinality(a, b),
            arity=2, iterations=n, seed=3,
        ),
    )
    _run(
        "serde-roundtrip",
        lambda: verify_invariance(
            "serde-roundtrip",
            lambda a: RB.deserialize(a.serialize()) == a
            and RB.deserialize(a.serialize()).serialize() == a.serialize(),
            arity=1, iterations=n, seed=5,
        ),
    )
    _run(
        "rank-select-inverse",
        lambda: verify_invariance(
            "rank-select-inverse",
            lambda a: all(
                a.rank(a.select(j)) == j + 1
                for j in {0, a.get_cardinality() // 2, a.get_cardinality() - 1}
            ),
            arity=1, iterations=n, seed=6,
        ),
    )
    _run(
        "wide-or-engines-agree",
        lambda: verify_invariance(
            "wide-or-engines-agree",
            lambda a, b, c: FA.or_(a, b, c, mode="cpu")
            == RB.or_(RB.or_(a, b), c)
            and FA.or_(a, b, c, mode="device") == RB.or_(RB.or_(a, b), c),
            arity=3, iterations=n, seed=8,
        ),
    )

    def _card_engines_agree(a, b, c):
        for fn, naive in (
            (FA.or_cardinality, FA.naive_or),
            (FA.and_cardinality, FA.naive_and),
            (FA.xor_cardinality, FA.naive_xor),
        ):
            want = naive(a, b, c).get_cardinality()  # one oracle per op
            if any(fn(a, b, c, mode=m) != want for m in ("cpu", "device")):
                return False
        return True

    _run(
        "cardinality-only-engines-agree",
        lambda: verify_invariance(
            "cardinality-only-engines-agree",
            _card_engines_agree,
            arity=3, iterations=max(1, n // 4), seed=9,
        ),
        actual=max(1, n // 4),
    )
    _run(
        "addOffset-roundtrip",
        lambda: verify_invariance(
            "addOffset-roundtrip",
            lambda a: RB.add_offset(RB.add_offset(a, 1 << 20), -(1 << 20)) == a,
            arity=1, iterations=n, seed=41,
        ),
    )
    _run(
        "selectRange-matches-slice",
        lambda: verify_invariance(
            "selectRange-matches-slice",
            _select_range_pred,
            arity=1, iterations=n, seed=42,
        ),
    )
    _run(
        "iterators-agree",
        lambda: verify_invariance(
            "iterators-agree", _iterators_pred, arity=1, iterations=max(1, n // 4), seed=43
        ),
        actual=max(1, n // 4),
    )
    _run(
        "subset-and-intersects",
        lambda: verify_invariance(
            "subset-and-intersects",
            lambda a, b: a.contains_bitmap(RB.and_(a, b))
            and RB.or_(a, b).contains_bitmap(a)
            and RB.intersects(a, b) == (RB.and_cardinality(a, b) > 0),
            arity=2, iterations=n, seed=44,
        ),
    )
    # device-layout invariance: all three layouts by construction, all CPU
    # engines (segmented-scan from the third iteration on)
    _run(
        "device-layouts-vs-cpu-engines(or)",
        lambda: verify_layout_invariance(
            "device-layouts-vs-cpu-engines(or)", op="or", iterations=n, seed=31
        ),
    )
    _run(
        "device-layouts-vs-cpu-engines(xor)",
        lambda: verify_layout_invariance(
            "device-layouts-vs-cpu-engines(xor)", op="xor", iterations=max(1, n // 4), seed=32
        ),
        actual=max(1, n // 4),
    )
    _run(
        "buffer-heap-equivalence",
        lambda: verify_buffer_invariance(
            "buffer-heap-equivalence",
            lambda ma, mb, ha, hb: ma.serialize() == ha.serialize()
            and RB.and_cardinality(ma, mb) == RB.and_cardinality(ha, hb),
            arity=2, iterations=max(1, n // 4), seed=21,
        ),
        actual=max(1, n // 4),
    )
    _run(
        "64bit-cross-design",
        lambda: verify_invariance64(
            "64bit-cross-design",
            lambda a, b: _cross64(a, b),
            arity=2, iterations=max(1, n // 8), seed=22,
        ),
        actual=max(1, n // 8),
    )
    # reference wire-format roundtrip, bulk reads, 64-bit vectorized
    # membership
    _run(
        "rangebitmap-wire-roundtrip",
        lambda: verify_invariance(
            "rangebitmap-wire-roundtrip",
            _rangebitmap_wire_pred,
            arity=1, iterations=max(1, n // 8), seed=45,
        ),
        actual=max(1, n // 8),
    )
    _run(
        "bsi-bulk-reads-agree",
        lambda: verify_invariance(
            "bsi-bulk-reads-agree",
            _bsi_bulk_pred,
            arity=1, iterations=max(1, n // 8), seed=46,
        ),
        actual=max(1, n // 8),
    )
    _run(
        "contains-many-64-agrees",
        lambda: verify_invariance(
            "contains-many-64-agrees",
            _contains_many64_pred,
            arity=1, iterations=max(1, n // 8), seed=47,
        ),
        actual=max(1, n // 8),
    )
    # the batched multi-predicate counts and the ranged andNot facade
    # overload
    _run(
        "batched-counts-agree",
        lambda: verify_invariance(
            "batched-counts-agree",
            _batched_counts_pred,
            arity=1, iterations=max(1, n // 8), seed=48,
        ),
        actual=max(1, n // 8),
    )
    _run(
        "ranged-andnot-agrees",
        lambda: verify_invariance(
            "ranged-andnot-agrees",
            _ranged_andnot_pred,
            arity=2, iterations=max(1, n // 8), seed=49,
        ),
        actual=max(1, n // 8),
    )
    _run(
        "bulk-order-stats-agree",
        lambda: verify_invariance(
            "bulk-order-stats-agree",
            _bulk_order_stats_pred,
            arity=1, iterations=max(1, n // 8), seed=50,
        ),
        actual=max(1, n // 8),
    )
    # query engine (planner + executor + cache) vs naive algebra, on both
    # forced regimes
    _run(
        "query-planner-vs-naive",
        lambda: verify_query_invariance(
            "query-planner-vs-naive", iterations=max(1, n // 4), seed=51
        ),
        actual=max(1, n // 4),
    )
    _run(
        "query-planner-vs-naive(device)",
        lambda: verify_query_invariance(
            "query-planner-vs-naive(device)",
            iterations=max(1, n // 8), seed=52, mode="device",
        ),
        actual=max(1, n // 8),
    )
    # resident pack cache — delta repack vs from-scratch pack on randomized
    # mutation sequences (both unfiltered and AND-filtered)
    _run(
        "pack-cache-delta-vs-full-repack",
        lambda: verify_pack_cache_invariance(
            "pack-cache-delta-vs-full-repack", iterations=max(1, n // 8), seed=53
        ),
        actual=max(1, n // 8),
    )
    # columnar batched pairwise engine vs the per-container engine under
    # randomized op sequences (incl. mapped + run operands)
    _run(
        "columnar-vs-percontainer",
        lambda: verify_columnar_invariance(
            "columnar-vs-percontainer", iterations=max(1, n // 4), seed=54
        ),
        actual=max(1, n // 4),
    )
    # random op/query sequences under random seeded fault schedules vs the
    # no-fault oracle — bit-exact, nothing escapes but the departure
    # (derated: each iteration is a multi-step sequence with per-step
    # oracle recomputation)
    _run(
        "fault-schedule-vs-oracle",
        lambda: verify_fault_schedule_invariance(
            "fault-schedule-vs-oracle", iterations=max(1, n // 8), seed=55
        ),
        actual=max(1, n // 8),
    )
    # random overlapping expression sets through the fusion window vs the
    # serial per-query oracle, incl. seeded fault schedules (derated: each
    # iteration executes a whole multi-query window plus its per-query
    # oracle)
    _run(
        "fused-concurrent-vs-serial",
        lambda: verify_fusion_invariance(
            "fused-concurrent-vs-serial", iterations=max(1, n // 8), seed=57
        ),
        actual=max(1, n // 8),
    )
    # seeded multi-tenant traffic through the serving harness (admission
    # -> fusion window, multi-threaded) vs the same query multiset executed
    # serially, incl. seeded fault schedules (derated: each iteration runs
    # a whole threaded harness window plus its serial oracle)
    _run(
        "concurrent-serve-vs-serial",
        lambda: verify_serve_invariance(
            "concurrent-serve-vs-serial", iterations=max(1, n // 8), seed=58
        ),
        actual=max(1, n // 8),
    )
    # threaded queries under concurrent ingest + epoch flips (incl. seeded
    # fault schedules over the epoch.flip site) must each match the
    # snapshot of the epoch they were admitted under — zero torn reads
    # (derated: each iteration runs a threaded window plus a per-epoch
    # lineage-replay oracle)
    _run(
        "concurrent-ingest-vs-epoch-oracle",
        lambda: verify_epoch_invariance(
            "concurrent-ingest-vs-epoch-oracle", iterations=max(1, n // 8),
            seed=59,
        ),
        actual=max(1, n // 8),
    )
    # randomized ingest with FORCED maintenance passes (incl. seeded fault
    # schedules biased toward the serve.maintain site, which must fail
    # closed) vs a no-compaction twin — compaction may change
    # representation, never content, and the passes' bit-identity audits
    # must report zero anomalies (derated: each iteration replays its
    # whole lineage into the twin)
    _run(
        "compaction-vs-identity-oracle",
        lambda: verify_compaction_invariance(
            "compaction-vs-identity-oracle", iterations=max(1, n // 8),
            seed=60,
        ),
        actual=max(1, n // 8),
    )
    # a subprocess killed WITHOUT UNWINDING at a random durable.persist
    # crash point must recover bit-exactly to the last published epoch vs
    # the deterministic replay oracle (derated hard: every iteration pays
    # a full interpreter spawn + import)
    _run(
        "crash-at-any-flip-stage-vs-recovery-oracle",
        lambda: verify_durable_crash_invariance(
            "crash-at-any-flip-stage-vs-recovery-oracle",
            iterations=max(1, n // 64), seed=61,
        ),
        actual=max(1, n // 64),
    )
    return results


def _batched_counts_pred(a) -> bool:
    """compare_cardinality_many must agree with the single-predicate engine
    on a BSI derived from the fuzz bitmap, across ops, modes, and a RANGE
    batch with per-query ends."""
    from .models.bsi import Operation, RoaringBitmapSliceIndex

    cols = a.to_array()
    if cols.size == 0:
        return True
    vals = (cols.astype(np.int64) * 2654435761) % (1 << 22)
    b = RoaringBitmapSliceIndex()
    b.set_values((cols, vals))
    qs = [int(vals[0]), int(vals.min()), int(vals.max()) + 7, 0]
    for op in (Operation.GE, Operation.LT, Operation.NEQ):
        want = [b.compare_cardinality(op, q, 0, None, mode="cpu") for q in qs]
        for mode in ("cpu", "device"):
            if b.compare_cardinality_many(op, qs, mode=mode).tolist() != want:
                return False
    ends = [q + 1000 for q in qs]
    want = [
        b.compare_cardinality(Operation.RANGE, q, e, None, mode="cpu")
        for q, e in zip(qs, ends)
    ]
    return (
        b.compare_cardinality_many(Operation.RANGE, qs, ends=ends, mode="device").tolist()
        == want
    )


def _bulk_order_stats_pred(a) -> bool:
    """rank_many/select_many/contains_many must agree with a sorted-array
    numpy oracle on the heap bitmap, the mapped immutable view, and (via
    a 64-bit lift) both 64-bit designs. Probes mix in-domain misses with
    exact members so the <= boundary is pinned on every surface."""
    from .models.immutable import ImmutableRoaringBitmap
    from .models.roaring64 import Roaring64NavigableMap
    from .models.roaring64art import Roaring64Bitmap

    arr = a.to_array()
    if arr.size == 0:
        return True
    u = np.sort(arr)
    rng = np.random.default_rng(int(u[0]) + u.size)
    ranks = rng.integers(0, u.size, 64)
    # in-domain misses + exact members (the <= boundary case)
    probes = np.concatenate(
        [rng.integers(0, int(u[-1]) + 2, 48).astype(np.uint32), u[ranks[:16]]]
    )
    want_rank = np.searchsorted(u, probes, side="right")
    want_in = np.isin(probes, u)
    for bm in (a, ImmutableRoaringBitmap(a.serialize())):
        if not np.array_equal(bm.rank_many(probes), want_rank):
            return False
        if not np.array_equal(bm.select_many(ranks), u[ranks]):
            return False
        if not np.array_equal(bm.contains_many(probes), want_in):
            return False
    lifted = (u.astype(np.uint64) << np.uint64(20)) | np.uint64(5)
    p64 = np.concatenate(
        [probes.astype(np.uint64) << np.uint64(20), lifted[ranks[:16]]]
    )
    want64 = np.searchsorted(lifted, p64, side="right")
    for bm64 in (Roaring64NavigableMap(), Roaring64Bitmap()):
        bm64.add_many(lifted)
        if not np.array_equal(bm64.rank_many(p64), want64):
            return False
        if not np.array_equal(bm64.select_many(ranks), lifted[ranks]):
            return False
        if not np.array_equal(bm64.contains_many(p64), np.isin(p64, lifted)):
            return False
    return True


def _ranged_andnot_pred(a, b) -> bool:
    """andnot_range == (a \\ b) masked to the range, built through an
    independent construction (bitmap_of_range AND)."""
    from .models.roaring import RoaringBitmap as RB

    last = a.last() if not a.is_empty() else 1000
    lo, hi = last // 3, max(last // 3 + 1, (2 * last) // 3)
    got = RB.andnot_range(a, b, lo, hi)
    mask = RB.bitmap_of_range(lo, hi)
    want = RB.and_(RB.andnot(a, b), mask)
    return got == want


def _select_range_pred(a) -> bool:
    arr = a.to_array()
    card = arr.size
    lo, hi = card // 4, max(card // 4 + 1, (3 * card) // 4)
    got = a.select_range(lo, hi)
    return np.array_equal(got.to_array(), arr[lo:hi])


def _iterators_pred(a) -> bool:
    arr = a.to_array()
    it = a.get_int_iterator()
    fwd = []
    while it.has_next():
        fwd.append(it.next())
    if not np.array_equal(np.array(fwd, dtype=np.int64), arr.astype(np.int64)):
        return False
    batches = []
    for b in a.batch_iterator(257):
        batches.append(b)
    got = np.concatenate(batches) if batches else np.empty(0, dtype=np.uint32)
    return np.array_equal(got, arr)


def _rangebitmap_wire_pred(a) -> bool:
    """RangeBitmap reference-format invariants: the bitmap's values become
    a value column; the sealed index must answer identically through the
    appender's build, the mapped reference bytes, the mapped native bytes, and a
    native->reference re-encode (the wire inversion is an involution)."""
    from .models.range_bitmap import RangeBitmap

    arr = a.to_array()
    if arr.size == 0:
        return True
    vals = (arr.astype(np.uint64) * np.uint64(2654435761)) % np.uint64(100_000)
    app = RangeBitmap.appender(99_999)
    app.add_many(vals)
    built = app.build()
    q = int(vals[len(vals) // 2])
    want = built.lte(q).to_array()
    want_between = built.between_cardinality(q // 2, q)
    java, native = built.serialize(form="java"), built.serialize(form="native")
    for data in (java, native, RangeBitmap.map(native).serialize(form="java")):
        m = RangeBitmap.map(data)
        if not np.array_equal(m.lte(q).to_array(), want):
            return False
        if m.between_cardinality(q // 2, q) != want_between:
            return False
    return RangeBitmap.map(java).serialize() == java


def _bsi_bulk_pred(a) -> bool:
    """BSI bulk get_values must agree with per-column get_value on a probe
    mix of present and absent columns (and the 64-bit twin likewise)."""
    from .models.bsi import RoaringBitmapSliceIndex
    from .models.bsi64 import Roaring64BitmapSliceIndex

    cols = a.to_array()
    if cols.size == 0:
        return True
    vals = (cols.astype(np.int64) * 7919) % (1 << 20)
    b = RoaringBitmapSliceIndex()
    b.set_values((cols, vals))
    probe = np.concatenate([cols[::7][:64], (cols[:32].astype(np.int64) + 1).astype(np.uint32)])
    got_v, got_e = b.get_values(probe)
    for p, v, e in zip(probe.tolist(), got_v.tolist(), got_e.tolist()):
        if (v, e) != b.get_value(p):
            return False
    b64 = Roaring64BitmapSliceIndex()
    cols64 = cols[:128].astype(np.uint64) << np.uint64(17)
    b64.set_values((cols64, vals[:128]))
    probe64 = np.concatenate([cols64[::3], cols64[:8] + np.uint64(1)])
    v64, e64 = b64.get_values(probe64)
    for p, v, e in zip(probe64.tolist(), list(v64), e64.tolist()):
        if (v, e) != b64.get_value(int(p)):
            return False
    return True


def _contains_many64_pred(a) -> bool:
    """Vectorized 64-bit membership agrees with scalar contains on both
    designs, over hits, misses, and cross-bucket probes."""
    from .models.roaring64 import Roaring64NavigableMap
    from .models.roaring64art import Roaring64Bitmap

    arr = a.to_array()
    if arr.size == 0:
        return True
    # size-capped: the <<33 spread scatters values across thousands of
    # high-48 chunks, so uncapped construction (not the probes) dominated
    # the family's wall clock; diversity across iterations matters more
    vals = (arr.astype(np.uint64) | (arr.astype(np.uint64) << np.uint64(33)))[:2048]
    probe = np.concatenate(
        [vals[::11][:32], vals[:16] ^ np.uint64(1 << 63), vals[:8] + np.uint64(1)]
    )
    for cls in (Roaring64Bitmap, Roaring64NavigableMap):
        bm = cls(vals)
        got = bm.contains_many(probe)
        for p, g in zip(probe.tolist(), got.tolist()):
            if g != bm.contains(int(p)):
                return False
    return True


def _cross64(a, b) -> bool:
    from .models.roaring64art import Roaring64Bitmap

    aa = Roaring64Bitmap(a.to_array())
    bb = Roaring64Bitmap(b.to_array())
    union = a.clone()
    union.ior(b)
    return union.serialize() == Roaring64Bitmap.or_(aa, bb).serialize()


def main(argv=None) -> int:
    """``python -m roaringbitmap_tpu_torch.fuzz [n] [--device cuda|cpu]``:
    the campaign at ``n`` iterations a family (default
    ``ROARINGBITMAP_TPU_FUZZ_ITERATIONS``), on the card unless asked for
    the CPU."""
    import argparse
    import time

    ap = argparse.ArgumentParser(description="Run the fuzz campaign.")
    ap.add_argument("n", nargs="?", type=int, default=None,
                    help="iterations a family (default: %(prog)s's env knob)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the device path runs (default: %(default)s)")
    args = ap.parse_args(argv)
    t0 = time.time()
    print(f"fuzz campaign: {args.n or default_iterations()} iterations/invariant "
          f"on {args.device}")
    res = run_campaign(args.n, device=args.device)
    print(
        f"campaign green: {len(res)} invariants x up to {max(res.values())} "
        f"iterations in {time.time()-t0:.0f}s"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
