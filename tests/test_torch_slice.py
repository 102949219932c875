"""The port's aggregation slice against the JAX package, end to end.

The same seeded value sets are built into both packages' bitmaps; the
port's ``FastAggregation`` / ``ParallelAggregation`` run the device path on
CPU tensors (``mode="device", device="cpu"``) and the JAX package runs its
device path on its CPU backend. Results must agree exactly: serialized
bytes, cardinalities, and the layout ``prepare_reduce`` picks. The file
also holds the port's boundary checks: no JAX import, no silent fallback
from ``device="cuda"``, and the interop state bridge.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from roaringbitmap_tpu.models.container import BitmapContainer as JBitmap
from roaringbitmap_tpu.models.container import RunContainer as JRun
from roaringbitmap_tpu.models.roaring import RoaringBitmap as JRB
from roaringbitmap_tpu.parallel import store as jstore
from roaringbitmap_tpu.parallel.aggregation import FastAggregation as JFA
from roaringbitmap_tpu.parallel.aggregation import ParallelAggregation as JPA

from roaringbitmap_tpu_torch import FastAggregation as TFA
from roaringbitmap_tpu_torch import ParallelAggregation as TPA
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch import interop
from roaringbitmap_tpu_torch.device import resolve_device
from roaringbitmap_tpu_torch.ops import kernels as K
from roaringbitmap_tpu_torch.parallel import aggregation
from roaringbitmap_tpu_torch.parallel import store as tstore
from roaringbitmap_tpu_torch.robust.errors import TierUnavailable

REPO = Path(__file__).resolve().parents[1]
SEED = 0xFEEF1F0
OPS = ("or", "and", "xor")
ENGINE = {"or": "or_", "and": "and_", "xor": "xor"}


def _chunk(rng, key, shape):
    """Values of one 2^16 chunk: sparse (array), dense (bitmap) or
    clustered runs."""
    if shape == 0:
        lows = rng.choice(1 << 16, size=int(rng.integers(1, 3000)), replace=False)
    elif shape == 1:
        lows = rng.choice(1 << 16, size=int(rng.integers(5000, 40000)), replace=False)
    else:
        starts = rng.choice(np.arange(0, 1 << 16, 128), size=int(rng.integers(1, 40)), replace=False)
        lows = np.concatenate([np.arange(s, s + int(rng.integers(1, 120))) for s in starts])
    return (key << 16) + np.unique(lows).astype(np.int64)


def _values(rng, key_counts):
    """One value set per bitmap; bitmap j holds chunk key k iff
    j < key_counts[k], so key k's group has key_counts[k] rows."""
    n = int(max(key_counts))
    return [
        np.concatenate(
            [_chunk(rng, k, int(rng.integers(0, 3))) for k, c in enumerate(key_counts) if j < c]
        ).astype(np.uint32)
        for j in range(n)
    ]


def _sets():
    rng = np.random.default_rng(SEED)
    return {
        # every key in every bitmap: the padded layout
        "padded": _values(rng, [24] * 6),
        # 8 groups of 64 rows plus 8 of 1 row: the bucketed layout
        "bucketed": _values(rng, [64] * 8 + [1] * 8),
        # a ~1.34x geometric ladder from 1 to 146 rows: the segmented layout
        "segmented": _values(rng, list(np.round(146 ** (np.arange(18) / 17)).astype(int))),
    }


SETS = _sets()


@pytest.fixture(autouse=True)
def _empty_pack_cache(monkeypatch):
    """The device path on CPU tensors unless a test asks for the card (a
    pairwise op the columnar cost model routes would otherwise calibrate
    the device tier there). The device-path aggregations keep their packs
    in the shared pack cache; empty it after each test so none stays
    resident."""
    monkeypatch.setattr(aggregation.config, "device", "cpu")
    yield
    tstore.PACK_CACHE.close()


def _pair(vals, run_every=3):
    """The same bitmaps in both packages; every ``run_every``-th one is
    run-optimized in both (none when ``run_every`` is 0)."""
    jb, tb = [], []
    for i, v in enumerate(vals):
        a, b = JRB(v), TRB(v)
        if run_every and i % run_every == 0:
            a.run_optimize()
            b.run_optimize()
        jb.append(a)
        tb.append(b)
    return jb, tb


def _layouts(jb, tb, op):
    keys = jstore.intersect_keys(jb) if op == "and" else None
    jpacked = jstore.pack_groups(jstore.group_by_key(jb, keys_filter=keys))
    tpacked = tstore.pack_groups(tstore.group_by_key(tb, keys_filter=keys), "cpu")
    return jstore.prepare_reduce(jpacked, op)[1], tstore.prepare_reduce(tpacked, op)[1]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("name", sorted(SETS))
def test_fast_aggregation_matches_jax_package(name, op):
    jb, tb = _pair(SETS[name])
    want = getattr(JFA, ENGINE[op])(*jb, mode="device")
    got = getattr(TFA, ENGINE[op])(*tb, mode="device", device="cpu")
    assert got.serialize() == want.serialize()
    assert got.get_cardinality() == want.get_cardinality()
    card = getattr(TFA, f"{op}_cardinality")(*tb, mode="device", device="cpu")
    assert card == getattr(JFA, f"{op}_cardinality")(*jb, mode="device")
    assert card == want.get_cardinality()


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("name", sorted(SETS))
def test_parallel_aggregation_matches_jax_package(name, op):
    jb, tb = _pair(SETS[name], run_every=2)
    want = getattr(JPA, ENGINE[op])(*jb, mode="device")
    got = getattr(TPA, ENGINE[op])(*tb, mode="device", device="cpu")
    assert got.serialize() == want.serialize()


@pytest.mark.parametrize("mode", ["cpu", "device"])
@pytest.mark.parametrize("name", sorted(SETS))
def test_fast_aggregation_andnot_matches_jax_package(name, mode):
    """``FastAggregation.andnot`` / ``andnot_cardinality`` (the query
    tier's n-way kernel) equal the JAX package's, mode for mode."""
    jb, tb = _pair(SETS[name])
    want = JFA.andnot(jb[0], *jb[1::4], mode=mode)
    got = TFA.andnot(tb[0], *tb[1::4], mode=mode)
    assert got.serialize() == want.serialize()
    assert 0 < got.get_cardinality() < tb[0].get_cardinality()
    assert TFA.andnot([tb[0]] + tb[1::4], mode=mode).serialize() == want.serialize()
    card = TFA.andnot_cardinality(tb[0], *tb[1::4], mode=mode)
    assert card == JFA.andnot_cardinality(jb[0], *jb[1::4], mode=mode) == want.get_cardinality()
    assert TFA.andnot(tb[0], mode=mode).serialize() == tb[0].serialize()
    assert TFA.andnot_cardinality(tb[0], mode=mode) == tb[0].get_cardinality()
    assert TFA.andnot(TRB(), tb[1], mode=mode).is_empty()


@pytest.mark.parametrize("name", sorted(SETS))
def test_parallel_group_by_key_matches_jax_package(name):
    jb, tb = _pair(SETS[name], run_every=2)
    want = JPA.group_by_key(*jb)
    got = TPA.group_by_key(tb)
    assert sorted(got) == sorted(want)
    for k, cs in want.items():
        assert [type(c).__name__ for c in got[k]] == [type(c).__name__ for c in cs]
        assert all(np.array_equal(a.to_array(), b.to_array()) for a, b in zip(got[k], cs))
    assert TPA.group_by_key(TRB([1, 1 << 16]), TRB([2, 2 << 16])).keys() == {0, 1, 2}


@pytest.mark.parametrize(
    "name, layout",
    [("padded", "padded"), ("bucketed", "bucketed"), ("segmented", "segmented-scan")],
)
def test_layout_choice_matches_jax_package(name, layout):
    jb, tb = _pair(SETS[name])
    for op in ("or", "xor"):
        assert _layouts(jb, tb, op) == (layout, layout)


def test_device_path_runs_the_kernel_wrappers_and_padded_layout_touches():
    """The padded layout's first run reads through the row map (cold fused
    gather); the second touch builds the padded block and reads it."""
    _, tb = _pair(SETS["padded"])
    launches = dict(K.LAUNCHES)
    packed = tstore.pack_groups(tstore.group_by_key(tb), "cpu")
    run, layout = tstore.prepare_reduce(packed, "or")
    assert layout == "padded" and 0 not in packed._padded_cache
    red1, card1 = run()
    run2, _ = tstore.prepare_reduce(packed, "or")
    red2, card2 = run2()
    assert 0 in packed._padded_cache
    assert torch.equal(red1, red2) and torch.equal(card1, card2)
    assert K.LAUNCHES == launches  # CPU tensors: plain versions, no launch


def test_cpu_fold_matches_jax_package_values():
    jb, tb = _pair(SETS["padded"])
    for op in OPS:
        want = getattr(JFA, ENGINE[op])(*jb, mode="cpu")
        got = getattr(TFA, ENGINE[op])(*tb, mode="cpu")
        assert np.array_equal(got.to_array(), want.to_array())
    assert TFA.naive_or(*tb).serialize() == JFA.naive_or(*jb).serialize()
    assert TFA.naive_xor(*tb).serialize() == JFA.naive_xor(*jb).serialize()
    assert np.array_equal(TFA.naive_and(*tb).to_array(), JFA.naive_and(*jb).to_array())


@pytest.mark.parametrize("name", sorted(SETS))
def test_serialized_bytes_cross_the_packages(name):
    jb, tb = _pair(SETS[name])
    for a, b in zip(jb[:12], tb[:12]):
        blob = a.serialize()
        assert b.serialize() == blob
        assert TRB.deserialize(blob).serialize() == blob


def _jax_state(bm):
    """The interop state dict read straight out of a JAX-package bitmap."""
    hlc = bm.high_low_container
    kinds, parts, words = [], [], []
    for c in hlc.containers:
        if isinstance(c, JRun):
            pairs = np.empty(2 * c.starts.size, dtype=np.uint16)
            pairs[0::2], pairs[1::2] = c.starts, c.lengths
            kinds.append(2)
            parts.append(pairs)
        elif isinstance(c, JBitmap):
            kinds.append(1)
            parts.append(np.empty(0, dtype=np.uint16))
            words.append(c.words)
        else:
            kinds.append(0)
            parts.append(np.asarray(c.content, dtype=np.uint16))
    return {
        "keys": np.asarray(hlc.keys, dtype=np.uint16),
        "kinds": np.asarray(kinds, dtype=np.uint8),
        "offsets": np.concatenate(([0], np.cumsum([p.size for p in parts]))).astype(np.int64),
        "u16_payload": np.concatenate(parts) if parts else np.empty(0, np.uint16),
        "words": np.stack(words) if words else np.empty((0, 1024), np.uint64),
    }


@pytest.mark.parametrize("run_optimize", [False, True])
def test_interop_round_trip_of_jax_bitmaps(run_optimize):
    jb, _ = _pair(SETS["segmented"][:40], run_every=1 if run_optimize else 0)
    assert any(isinstance(c, JRun) for b in jb for c in b.high_low_container.containers) == run_optimize
    for a in jb:
        state = _jax_state(a)
        b = interop.from_state(state)
        assert b.serialize() == a.serialize()
        back = interop.to_state(b)
        assert state.keys() == back.keys()
        for k in state:
            assert back[k].dtype == state[k].dtype and np.array_equal(back[k], state[k])


def test_interop_rejects_inconsistent_state():
    state = interop.to_state(TRB(np.arange(0, 200000, 3, dtype=np.uint32)))
    bad = dict(state, kinds=state["kinds"][:-1])
    with pytest.raises(ValueError):
        interop.from_state(bad)


def test_import_leaves_jax_and_the_jax_package_out():
    # only what the port's imports add counts (a site hook may import
    # things before any code of ours runs)
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import roaringbitmap_tpu_torch\n"
        "from roaringbitmap_tpu_torch.parallel import store, aggregation\n"
        "from roaringbitmap_tpu_torch.ops import kernels, _build\n"
        "from roaringbitmap_tpu_torch.models import bsi, bsi_buffer, range_bitmap\n"
        "from roaringbitmap_tpu_torch.models import immutable, buffer, iterators, writer, bitset, fastrank\n"
        "from roaringbitmap_tpu_torch import insights\n"
        "from roaringbitmap_tpu_torch import interop, serialization, columnar\n"
        "from roaringbitmap_tpu_torch.columnar import costmodel, device, engine\n"
        "from roaringbitmap_tpu_torch.models import art, roaring64, roaring64art, bsi64\n"
        "from roaringbitmap_tpu_torch.parallel import aggregation64, sharding\n"
        "from roaringbitmap_tpu_torch import Q, query, FastAggregation64, Roaring64Bitmap\n"
        "from roaringbitmap_tpu_torch import observe, tracing\n"
        "from roaringbitmap_tpu_torch.observe import timeline, spans, export, decisions, outcomes\n"
        "from roaringbitmap_tpu_torch.observe import compilewatch, context, artifacts, compat\n"
        "from roaringbitmap_tpu_torch.robust import errors, faults, ladder\n"
        "from roaringbitmap_tpu_torch.observe import health, sentinel, bundle, structure, lockstats\n"
        "from roaringbitmap_tpu_torch.cost import fusion as fusion_cost\n"
        "from roaringbitmap_tpu_torch.query import fusion, inflight\n"
        "from roaringbitmap_tpu_torch.parallel import batch\n"
        "from roaringbitmap_tpu_torch import cost, serve\n"
        "from roaringbitmap_tpu_torch.cost import admission, breakeven, compaction, epoch, facade, residency\n"
        "from roaringbitmap_tpu_torch.serve import harness, slo, ingest, epochs, maintain\n"
        "from roaringbitmap_tpu_torch import durable\n"
        "from roaringbitmap_tpu_torch.durable import format, recovery, store as dstore\n"
        "from roaringbitmap_tpu_torch import fuzz, analysis\n"
        "from roaringbitmap_tpu_torch.analysis import baseline, cfg, core, knobs, lockwitness, project\n"
        "from roaringbitmap_tpu_torch.analysis import rules\n"
        "from roaringbitmap_tpu_torch.analysis import __main__ as analysis_cli\n"
        "analysis.run_contract_checks(analysis.get_project(analysis_cli.REPO_ROOT))\n"
        "insights.observatory(); bundle._collect_sections(None)\n"
        "insights.epochs(); insights.structure(); insights.durable()\n"
        "cost.calibration_state(); cost.refit_all(); insights.serving(); insights.cost_authorities()\n"
        "fusion.autotune_window(reason='import-check')\n"
        "bad = [m for m in set(sys.modules) - before\n"
        "       if m in ('jax', 'jaxlib', 'roaringbitmap_tpu')\n"
        "       or m.startswith(('jax.', 'jaxlib.', 'roaringbitmap_tpu.'))]\n"
        "print(sorted(bad), len(set(sys.modules) - before) > 0)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] True"


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_the_port_mirrors_every_jax_module_but_the_tooling():
    """A file-by-file diff of the two trees: every module of the JAX
    package has its counterpart in the port, the tooling (``fuzz.py`` and
    ``analysis/``) included, except ``ops/pallas_kernels.py`` (its
    counterparts are the CUDA sources under ``csrc/``, behind
    ``ops/kernels.py``) and the analyzer's ``trace-safety`` and
    ``use-after-donation`` rules (the port has no jit and donates no
    buffer)."""
    jroot, troot = REPO / "roaringbitmap_tpu", REPO / "roaringbitmap_tpu_torch"
    jax_files = {p.relative_to(jroot) for p in jroot.rglob("*.py")}
    port_files = {p.relative_to(troot) for p in troot.rglob("*.py")}
    missing = sorted(str(p) for p in jax_files - port_files)
    assert missing == ["analysis/rules/donation.py", "analysis/rules/trace_safety.py",
                       "ops/pallas_kernels.py"]
    assert (troot / "csrc" / "reduce.cu").is_file() and (troot / "ops" / "kernels.py").is_file()
    assert (troot / "fuzz.py").is_file() and (troot / "analysis" / "__main__.py").is_file()


def test_no_port_file_imports_jax_or_the_jax_package():
    files = sorted((REPO / "roaringbitmap_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for name in _imported_modules(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "roaringbitmap_tpu"), f"{path}: imports {name}"


@pytest.mark.cuda
@pytest.mark.parametrize("op", OPS)
def test_cuda_aggregation_matches_the_cpu_device_path(op):
    """On the card: the aggregation through the CUDA kernels equals the
    same device path on CPU tensors (itself held against the JAX package
    above). Skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    rng = np.random.default_rng(SEED)
    key_counts = [40] * 6 + [64] * 2 + [1] * 3  # bucketed for or/xor, padded for and
    bms = []
    for j in range(64):
        vals = np.concatenate([
            (k << 16) + rng.choice(1 << 16, int(rng.integers(1, 9000)), replace=False)
            for k, c in enumerate(key_counts) if j < c
        ]).astype(np.uint32)
        bms.append(TRB(vals))
        if j % 3 == 0:
            bms[-1].run_optimize()
    before = sum(K.LAUNCHES.values())
    got = getattr(TFA, ENGINE[op])(*bms, mode="device", device="cuda")
    want = getattr(TFA, ENGINE[op])(*bms, mode="device", device="cpu")
    assert got.serialize() == want.serialize()
    assert sum(K.LAUNCHES.values()) > before


def test_cuda_without_a_card_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.setattr(aggregation.config, "device", "cuda")  # as shipped
    _, tb = _pair(SETS["padded"])
    with pytest.raises(TierUnavailable):
        resolve_device("cuda")
    with pytest.raises(TierUnavailable):
        TFA.or_(*tb, mode="device", device="cuda")
    with pytest.raises(TierUnavailable):
        TFA.or_cardinality(*tb, mode="device")  # default device is cuda
    # mode="auto" decides by working-set size only: above the gate it takes
    # the device path (and raises here), below it the CPU fold
    with pytest.raises(TierUnavailable):
        TFA.or_(*tb)
    small = tb[:2]
    assert sum(b.get_container_count() for b in small) < 64
    assert TFA.or_(*small).serialize() == TFA.naive_or(*small).serialize()


@pytest.mark.parametrize("threads", [4, 8])
def test_the_serving_slice_end_to_end_matches_the_jax_package(threads, monkeypatch):
    """The slice as a whole on the CPU: three declared tenants (an
    interactive one, a batch tenant of wide Q1-shaped steps, a low quota)
    through admission, the hedged fusion window and the device path on CPU
    tensors; every served result equals the JAX package's serial oracle,
    every unserved one is a typed shed; then the cost facade refits from
    the traffic's own ledger with a report for each of the eight
    authorities, and the serving rules read values."""
    from roaringbitmap_tpu import query as jq
    from roaringbitmap_tpu import serve as jserve
    from roaringbitmap_tpu_torch import cost as tcost
    from roaringbitmap_tpu_torch import insights
    from roaringbitmap_tpu_torch import query as tq
    from roaringbitmap_tpu_torch import serve as tserve
    from roaringbitmap_tpu_torch.observe import health, outcomes

    monkeypatch.setattr(aggregation.config, "device", "cpu")
    rng = np.random.default_rng(77)
    vals = [np.sort(rng.choice(1 << 20, 3000, replace=False)).astype(np.uint32) for _ in range(24)]
    tc, jc = [TRB(v) for v in vals], [JRB(v) for v in vals]

    def profiles(serve, Q):
        def q1(rng_, corpus, shared):
            n = len(corpus) // 3
            return ((Q.or_(*corpus[:n]) & Q.or_(*corpus[n:2 * n])) - Q.or_(*corpus[2 * n:])) | \
                Q.threshold(2, *corpus[:8])
        return [serve.TenantProfile("e2e-int", weight=2.0, quota_qps=1e6, latency_class="interactive"),
                serve.TenantProfile("e2e-bat", weight=1.0, quota_qps=1e6, mix=q1),
                serve.TenantProfile("e2e-low", weight=1.0, quota_qps=0.1, burst=1.0)]

    tserve.slo.reset()
    outcomes.reset()
    tstore.PACK_CACHE.close()
    try:
        tprof, jprof = profiles(tserve, tq.Q), profiles(jserve, jq.Q)
        treqs = tserve.build_requests(tc, tprof, 60, seed=4)
        jreqs = jserve.build_requests(jc, jprof, 60, seed=4)
        oracle = [r.serialize() for r in jserve.LoadHarness(jc, jprof, threads=1).run_serial(jreqs)]
        h = tserve.LoadHarness(tc, tprof, threads=threads,
                               admission=tserve.AdmissionController(max_inflight=2 * threads, queue_limit=0))
        report = h.run(treqs)
        for got, want in zip(report.results, oracle):
            assert isinstance(got, tserve.ShedRejection) or got.serialize() == want
        assert report.stats["e2e-low"].shed > 0 and report.stats["e2e-bat"].served > 0
        reports = tcost.refit_all()
        assert sorted(reports) == tcost.names() and len(reports) == 8
        sites = {e["site"] for e in outcomes.tail()}
        assert {"serve.admit", "fusion.batch", "agg.dispatch"} <= sites
        rows = insights.serving()["tenants"]
        assert rows["e2e-int"]["bytes"] > 0 and rows["e2e-int"]["latency"]["execute"]["count"] > 0
        snap = health.snapshot(refresh_hbm=False)
        rule = next(r for r in health.DEFAULT_RULES if r.name == "serving-p99-pressure")
        assert rule.probe(snap) is None or rule.probe(snap) >= 0
    finally:
        tserve.slo.reset()
        tserve.CONTROLLER.reset()
        outcomes.reset()
        tstore.PACK_CACHE.close()
        jstore.PACK_CACHE.close()
