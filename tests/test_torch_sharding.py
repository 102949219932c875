"""The port's multi-device slice (``parallel/sharding.py`` and the mesh
routes) against the JAX package.

The JAX programs run on the virtual 8-device CPU mesh of ``conftest.py``;
the port's run in worlds of 1, 2, 4 and 8 gloo processes over a CPU
``DeviceMesh`` (``make_mesh(n, words_axis=2, device_type="cpu")``), where
every kernel wrapper takes its plain version. Both get the same seeded numpy
inputs, and the port's results, gathered on every rank, must equal the JAX
package's exactly: words, cards, counts and serialized bytes. Each world
runs once for the module (a fixture), its workers report case by case, and
each case is its own test. A world that outlives its join timeout is killed
and its cases fail.

Also here: the row widths the reduce, popcount and O'Neil kernels take
(their plain versions at 1024, 512 and 256 words against the 2048-word
result cut to those columns, and a ``cuda``-marked twin of each at 1024).
"""

import os
import pickle
import socket
import subprocess
import sys
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

from roaringbitmap_tpu_torch.ops import kernels as K

REPO = Path(__file__).resolve().parents[1]
SEED = 0xFEEF1F0
WORLDS = (1, 2, 4, 8)
JOIN_TIMEOUT_S = 120
ONEIL_OPS = ("EQ", "NEQ", "GT", "LT", "LE", "GE", "RANGE")

# the programs' inputs: K = 8 chunks and M = 8 rows divide over every
# containers axis here (at most 4) and over the JAX mesh's (4)
S_SLICES, K_CHUNKS, G_GROUPS, M_ROWS, N_WIDE = 5, 8, 3, 8, 16
PREDICATE, RANGE_LO, RANGE_HI = 0b10110, 0b00110, 0b11010
BATCH = (0b00101, 0b10110, 0b11011)


# ---------------------------------------------------------------------------
# seeded inputs, built alike in the workers and in the test process
# ---------------------------------------------------------------------------


def _u32(rng, shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)


def _sparse(rng, shape) -> np.ndarray:
    """About one bit in sixteen set: an OR of 8-16 rows stays short of
    all ones."""
    return _u32(rng, shape) & _u32(rng, shape) & _u32(rng, shape) & _u32(rng, shape)


def program_inputs() -> dict:
    rng = np.random.default_rng(SEED)
    slices = _u32(rng, (S_SLICES, K_CHUNKS, 2048))
    ebm = np.bitwise_or.reduce(slices, axis=0)
    found = _u32(rng, (K_CHUNKS, 2048))
    return {
        "wide": _sparse(rng, (N_WIDE, 2048)),
        "or": _sparse(rng, (G_GROUPS, M_ROWS, 2048)),
        "and": ~_sparse(rng, (G_GROUPS, M_ROWS, 2048)),
        "xor": _u32(rng, (G_GROUPS, M_ROWS, 2048)),
        "slices": slices,
        "ebm": ebm,
        "fixed": ebm & found,
        "found": found,
    }


def bits_high_first(v: int, s_count: int = S_SLICES) -> list:
    return [(v >> i) & 1 for i in range(s_count - 1, -1, -1)]


def compare_bits(op: str) -> np.ndarray:
    if op == "RANGE":
        return np.array([bits_high_first(RANGE_LO), bits_high_first(RANGE_HI)], dtype=bool)
    return np.array(bits_high_first(PREDICATE), dtype=bool)


def batch_bits(op: str) -> np.ndarray:
    if op == "RANGE":
        return np.array([[bits_high_first(v), bits_high_first(v | 0b11000)] for v in BATCH], dtype=bool)
    return np.array([bits_high_first(v) for v in BATCH], dtype=bool)


def agg_values() -> list:
    """40 bitmaps of 3,000 values over 8 key chunks (the JAX mesh tests'
    shape)."""
    rng = np.random.default_rng(SEED + 1)
    return [np.unique(rng.integers(0, 1 << 19, 3000)).astype(np.uint32) for _ in range(40)]


def skewed_values() -> list:
    """One key group of 600 rows and ten of one: too skewed for the dense
    pad, so the mesh route takes the unsharded reduce (on the bucketed
    layout, which ``prepare_reduce`` picks for it)."""
    rng = np.random.default_rng(SEED + 2)
    out = [np.unique(rng.integers(0, 1 << 16, 50)).astype(np.uint32) for _ in range(600)]
    out += [np.array([(k + 1) << 16 | 7], dtype=np.uint32) for k in range(10)]
    return out


def bsi_values():
    """Three key chunks (not a multiple of the 4-rank mesh's 2), 20
    slices, a found set of every third column."""
    rng = np.random.default_rng(SEED + 3)
    cols = np.sort(rng.choice(3 << 16, size=60_000, replace=False)).astype(np.uint32)
    vals = rng.integers(0, 1 << 20, size=cols.size).astype(np.int64)
    return cols, vals, cols[::3].copy(), int(np.median(vals))


def many_values():
    rng = np.random.default_rng(SEED + 4)
    cols = np.sort(rng.choice(600_000, size=40_000, replace=False)).astype(np.uint32)
    vals = rng.integers(0, 1 << 20, size=cols.size).astype(np.int64)
    found = rng.choice(900_000, size=30_000, replace=False).astype(np.uint32)
    qs = np.quantile(vals, [0.2, 0.5, 0.8]).astype(np.int64)
    return cols, vals, found, qs, qs + 5000


def many64_values():
    rng = np.random.default_rng(SEED + 5)
    cols = (1 << 33) + rng.choice(3 << 16, size=6_000, replace=False).astype(np.int64)
    vals = rng.integers(0, 1 << 24, size=cols.size).astype(np.int64)
    return cols, vals, np.quantile(vals, [0.25, 0.75]).astype(np.int64)


def plan_values() -> list:
    rng = np.random.default_rng(SEED + 6)
    return [np.unique(rng.integers(0, 1 << 20, 2000)).astype(np.uint32) for _ in range(12)]


# ---------------------------------------------------------------------------
# the worker: one rank of a gloo world, every case on the port
# ---------------------------------------------------------------------------


def _program_cases():
    """(name, fn(mesh) -> result) of the five programs, the result
    gathered on this rank as numpy."""
    from roaringbitmap_tpu_torch.parallel import sharding as sh

    x = program_inputs()
    rows, chunked = ("containers", "words"), (None, "containers", "words")

    def u32(t):
        return t.cpu().numpy().view(np.uint32)

    def wide(mesh):
        total, card = sh.distributed_wide_or_cardinality(mesh)(sh.shard_rows(mesh, x["wide"], rows))
        return u32(sh.gather_shards(mesh, total, ("words",))), int(card)

    def grouped(op):
        def run(mesh):
            red, cards = sh.distributed_grouped_reduce(mesh, op)(sh.shard_rows(mesh, x[op], chunked))
            return u32(sh.gather_shards(mesh, red, (None, "words"))), cards.numpy()
        return run

    def compare(op):
        def run(mesh):
            out, cards = sh.distributed_bsi_compare(mesh, op)(
                sh.shard_rows(mesh, x["slices"], chunked), compare_bits(op),
                sh.shard_rows(mesh, x["ebm"], rows), sh.shard_rows(mesh, x["fixed"], rows),
            )
            return (u32(sh.gather_shards(mesh, out, rows)),
                    sh.gather_shards(mesh, cards, ("containers",)).numpy())
        return run

    def bsi_sum(mesh):
        counts = sh.distributed_bsi_sum(mesh)(
            sh.shard_rows(mesh, x["slices"], chunked), sh.shard_rows(mesh, x["found"], rows)
        )
        return sh.gather_shards(mesh, counts, (None, "containers")).numpy()

    def counts(op):
        def run(mesh):
            cards = sh.distributed_bsi_counts_many(mesh, op)(
                sh.shard_rows(mesh, x["slices"], chunked), batch_bits(op),
                sh.shard_rows(mesh, x["ebm"], rows), sh.shard_rows(mesh, x["fixed"], rows),
            )
            return sh.gather_shards(mesh, cards, (None, "containers")).numpy()
        return run

    def collectives(mesh):
        step = sh.distributed_wide_or_cardinality(mesh)
        local = sh.shard_rows(mesh, x["wide"], rows)
        details = sh.collective_details(step, local)
        return sh.collective_summary(step, local), details, sh.distributed_wide_or_cardinality(mesh) is step

    cases = [("wide_or", wide)]
    cases += [(f"grouped[{op}]", grouped(op)) for op in ("or", "and", "xor")]
    cases += [(f"compare[{op}]", compare(op)) for op in ONEIL_OPS]
    cases += [("sum", bsi_sum)]
    cases += [(f"counts[{op}]", counts(op)) for op in ("GE", "NEQ", "RANGE")]
    cases += [("collectives", collectives)]
    return cases


def _facade_cases():
    """(name, fn(mesh) -> result) of the mesh routes: serialized bytes,
    counts, and how each route ran."""
    from roaringbitmap_tpu_torch import Roaring64BitmapSliceIndex, RoaringBitmap
    from roaringbitmap_tpu_torch.models import bsi as tbsi
    from roaringbitmap_tpu_torch.models import bsi64 as tbsi64
    from roaringbitmap_tpu_torch.models.bsi import Operation, RoaringBitmapSliceIndex
    from roaringbitmap_tpu_torch.parallel import aggregation, store
    from roaringbitmap_tpu_torch.parallel.aggregation import FastAggregation as FA
    from roaringbitmap_tpu_torch.query import Q, execute
    from roaringbitmap_tpu_torch.query import exec as qexec

    bms = [RoaringBitmap(v) for v in agg_values()]
    skewed = [RoaringBitmap(v) for v in skewed_values()]
    cols, vals, found_cols, med = bsi_values()
    index = RoaringBitmapSliceIndex()
    index.set_values((cols, vals))
    found = RoaringBitmap(found_cols)
    mcols, mvals, mfound, qs, ends = many_values()
    many = RoaringBitmapSliceIndex()
    many.set_values((mcols, mvals))
    many_found = RoaringBitmap(mfound)
    cols64, vals64, qs64 = many64_values()
    b64 = Roaring64BitmapSliceIndex()
    b64.set_values(list(zip(cols64.tolist(), vals64.tolist())))
    leaves = [RoaringBitmap(v) for v in plan_values()]

    def with_mesh(cfg, fn):
        def run(mesh):
            cfg.mesh = mesh
            try:
                return fn()
            finally:
                cfg.mesh = None
        return run

    def counting_launches(fn):
        """(fn(), the count-only O'Neil batches it ran: one rb_oneil_counts
        launch each on the card)."""
        calls = []
        real = K.oneil_compare

        def counted(slices, bits, ebm, fixed, op, count_only=False):
            if count_only and bits.shape[0] > 1:
                calls.append(bits.shape[0])
            return real(slices, bits, ebm, fixed, op, count_only)

        K.oneil_compare = counted
        try:
            return fn(), len(calls)
        finally:
            K.oneil_compare = real

    engines = {"or": FA.or_, "and": FA.and_, "xor": FA.xor}
    cards = {"or": FA.or_cardinality, "and": FA.and_cardinality, "xor": FA.xor_cardinality}
    cases = []
    for op in ("or", "and", "xor"):
        cases.append((f"fa[{op}]", with_mesh(aggregation.config, lambda op=op: engines[op](*bms, mode="device").serialize())))
        cases.append((f"fa_card[{op}]", with_mesh(aggregation.config, lambda op=op: cards[op](*bms, mode="device"))))

    def skew():
        before = dict(store.LAYOUT_COUNTS)
        got = FA.or_(*skewed, mode="device").serialize()
        return got, {k: v - before[k] for k, v in store.LAYOUT_COUNTS.items() if v != before[k]}

    cases.append(("fa_skew[or]", with_mesh(aggregation.config, skew)))
    for op in ONEIL_OPS:
        o = Operation[op]
        lo, hi = (med // 2, med) if op == "RANGE" else (med, 0)
        cases.append((f"bsi[{op}]", with_mesh(tbsi.config, lambda o=o, lo=lo, hi=hi: (
            index.compare(o, lo, hi, found, mode="device").serialize(),
            index.compare_cardinality(o, lo, hi, found, mode="device"),
        ))))
    cases.append(("bsi_sum", with_mesh(tbsi.config, lambda: index.sum(found, mode="device"))))
    for op, kw in (("GE", {"found_set": many_found}), ("NEQ", {"found_set": many_found}),
                   ("RANGE", {"ends": ends})):
        cases.append((f"many32[{op}]", with_mesh(tbsi.config, lambda op=op, kw=kw: counting_launches(
            lambda: many.compare_cardinality_many(Operation[op], qs, mode="device", **kw).tolist()))))
    cases.append(("many64[GE]", with_mesh(tbsi64.config, lambda: counting_launches(
        lambda: b64.compare_cardinality_many(Operation.GE, qs64, mode="device").tolist()))))

    def planned(mesh):
        expr = Q.or_(*[Q.leaf(b) for b in leaves])
        unsharded = qexec._memo_plan(expr, "device")
        aggregation.config.mesh = mesh
        try:
            sharded = qexec._memo_plan(expr, "device")
            got = execute(expr, cache=None, mode="device").serialize()
        finally:
            aggregation.config.mesh = None
        return ([s.engine for s in unsharded.steps], [s.engine for s in sharded.steps],
                sharded is not unsharded, got)

    cases.append(("plan", planned))
    return cases


FAILED = "__failed__"


def worker_main(rank: int, world: int, port: int, out_dir: str) -> None:
    """Run every case of a ``world``-rank gloo world as rank ``rank`` and
    pickle ``{case: result, or {FAILED: traceback}}`` to
    ``out_dir/rank<r>.pkl``."""
    import torch.distributed as dist

    from roaringbitmap_tpu_torch.models import bsi as tbsi
    from roaringbitmap_tpu_torch.parallel import aggregation, sharding

    aggregation.config.device = "cpu"
    tbsi.config.device = "cpu"
    sharding.initialize_multihost(
        f"tcp://127.0.0.1:{port}", world, rank, backend="gloo", timeout=JOIN_TIMEOUT_S
    )
    mesh = sharding.make_mesh(world, words_axis=2, device_type="cpu")
    cases = _program_cases() + _facade_cases()
    results = {"mesh": mesh.mesh.tolist()}
    for name, fn in cases:
        try:
            results[name] = fn(mesh)
        except Exception:  # reported to the case's own test
            results[name] = {FAILED: traceback.format_exc()}
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(n: int, out_dir: Path) -> list:
    """Spawn an ``n``-rank world; each rank's results, or a string saying
    why the world failed (a rank exited non-zero, or the world outlived
    its join timeout and was killed)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(REPO), str(REPO / "tests"), env.get("PYTHONPATH")]))
    env["OMP_NUM_THREADS"] = "1"
    port = _free_port()
    code = "import sys, test_torch_sharding as t; t.worker_main(*map(int, sys.argv[1:4]), sys.argv[4])"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", code, str(r), str(n), str(port), str(out_dir)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(n)
    ]
    logs = [""] * n
    try:
        for r, p in enumerate(procs):
            logs[r], _ = p.communicate(timeout=JOIN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        return f"world of {n} outlived its {JOIN_TIMEOUT_S} s join timeout and was killed"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        return f"rank {bad[0]} of {n} exited {procs[bad[0]].returncode}:\n{logs[bad[0]][-3000:]}"
    out = []
    for r in range(n):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """``worlds(n)``: the per-rank results of the n-rank world, run once
    for the module."""
    done = {}

    def get(n):
        if n not in done:
            done[n] = run_world(n, tmp_path_factory.mktemp(f"world{n}"))
        return done[n]

    return get


def _case(ranks, case):
    """The case's result, the same on every rank."""
    if isinstance(ranks, str):
        pytest.fail(ranks)
    first = ranks[0][case]
    if isinstance(first, dict) and FAILED in first:
        pytest.fail(first[FAILED])
    for r, res in enumerate(ranks[1:], 1):
        assert pickle.dumps(res[case]) == pickle.dumps(first), f"rank {r} differs from rank 0"
    return first


# ---------------------------------------------------------------------------
# the five programs against the JAX package's on its 8-device mesh
# ---------------------------------------------------------------------------


PROGRAM_CASES = (
    ["wide_or"] + [f"grouped[{op}]" for op in ("or", "and", "xor")]
    + [f"compare[{op}]" for op in ONEIL_OPS] + ["sum"]
    + [f"counts[{op}]" for op in ("GE", "NEQ", "RANGE")]
)


@pytest.fixture(scope="module")
def jax_programs():
    """The JAX programs' results on the virtual 8-device mesh, by case."""
    import jax.numpy as jnp

    from roaringbitmap_tpu.parallel import sharding as jsh

    mesh = jsh.make_mesh(8, words_axis=2)
    x = {k: jnp.asarray(v) for k, v in program_inputs().items()}
    out = {}
    total, card = jsh.distributed_wide_or_cardinality(mesh)(x["wide"])
    out["wide_or"] = (np.asarray(total), int(card))
    for op in ("or", "and", "xor"):
        red, cards = jsh.distributed_grouped_reduce(mesh, op)(x[op])
        out[f"grouped[{op}]"] = (np.asarray(red), np.asarray(cards))
    for op in ONEIL_OPS:
        res, cards = jsh.distributed_bsi_compare(mesh, op)(
            x["slices"], jnp.asarray(compare_bits(op)), x["ebm"], x["fixed"]
        )
        out[f"compare[{op}]"] = (np.asarray(res), np.asarray(cards))
    out["sum"] = np.asarray(jsh.distributed_bsi_sum(mesh)(x["slices"], x["found"]))
    for op in ("GE", "NEQ", "RANGE"):
        out[f"counts[{op}]"] = np.asarray(jsh.distributed_bsi_counts_many(mesh, op)(
            x["slices"], jnp.asarray(batch_bits(op)), x["ebm"], x["fixed"]
        ))
    return out


def _equal(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(want, np.ndarray):
        assert got.shape == want.shape
        assert np.array_equal(np.asarray(got).astype(np.int64), want.astype(np.int64))
    else:
        assert got == want


@pytest.mark.parametrize("case", PROGRAM_CASES)
@pytest.mark.parametrize("n", WORLDS)
def test_program_matches_jax(worlds, jax_programs, n, case):
    _equal(_case(worlds(n), case), jax_programs[case])


@pytest.mark.parametrize("n", WORLDS)
def test_world_forms_the_jax_mesh_shape(worlds, n):
    """The mesh is (containers, words) = (n / nw, nw), nw = 2 where it
    divides the world, as the JAX package's ``make_mesh`` shapes it."""
    ranks = worlds(n)
    if isinstance(ranks, str):
        pytest.fail(ranks)
    nw = 2 if n % 2 == 0 else 1
    assert ranks[0]["mesh"] == np.arange(n).reshape(n // nw, nw).tolist()


@pytest.mark.parametrize("n", WORLDS)
def test_wide_or_issues_one_all_gather_and_one_all_reduce(worlds, n):
    """The JAX pin (tests/test_sharding.py): the wide OR is one
    containers-axis all-gather plus one words-axis all-reduce, and no
    all-to-all or collective-permute; the step is cached per mesh."""
    counts, details, cached = _case(worlds(n), "collectives")
    assert counts == {"all-gather": 1, "all-reduce": 1}
    assert [(d["op"], d["axis"]) for d in details] == [("all-gather", "containers"), ("all-reduce", "words")]
    grid = np.arange(n).reshape(-1, 2 if n % 2 == 0 else 1)
    assert details[0]["replica_groups"] == grid.T.tolist()
    assert details[1]["replica_groups"] == grid.tolist()
    assert cached


# ---------------------------------------------------------------------------
# the mesh routes against the JAX package under its mesh
# ---------------------------------------------------------------------------


_JAX_WANT: dict = {}


def jax_want(case: str):
    """The JAX package's answer to a mesh-route case, its ``config.mesh``
    set to the virtual 8-device mesh; computed once a case."""
    if case in _JAX_WANT:
        return _JAX_WANT[case]
    from roaringbitmap_tpu import FastAggregation as JFA
    from roaringbitmap_tpu import Roaring64BitmapSliceIndex as JBSI64
    from roaringbitmap_tpu import RoaringBitmap as JRB
    from roaringbitmap_tpu.models import bsi as jbsi
    from roaringbitmap_tpu.models import bsi64 as jbsi64
    from roaringbitmap_tpu.models.bsi import Operation as JOp
    from roaringbitmap_tpu.parallel import aggregation as jagg
    from roaringbitmap_tpu.parallel import sharding as jsh
    from roaringbitmap_tpu.query import Q as JQ
    from roaringbitmap_tpu.query import exec as jexec

    kind, _, arg = case.partition("[")
    arg = arg.rstrip("]")
    cfg = {"fa": jagg, "fa_card": jagg, "fa_skew": jagg, "plan": jagg, "many64": jbsi64}.get(kind, jbsi)
    if kind in ("fa", "fa_card"):
        bms = [JRB(v) for v in agg_values()]
        name = {"or": "or_", "and": "and_", "xor": "xor"}[arg] if kind == "fa" else f"{arg}_cardinality"

        def run():
            got = getattr(JFA, name)(*bms, mode="device")
            return got.serialize() if kind == "fa" else got
    elif kind == "fa_skew":
        bms = [JRB(v) for v in skewed_values()]

        def run():
            return JFA.or_(*bms, mode="device").serialize()
    elif kind in ("bsi", "bsi_sum"):
        cols, vals, found_cols, med = bsi_values()
        index = jbsi.RoaringBitmapSliceIndex()
        index.set_values((cols, vals))
        found = JRB(found_cols)
        lo, hi = (med // 2, med) if arg == "RANGE" else (med, 0)

        def run():
            if kind == "bsi_sum":
                return index.sum(found, mode="device")
            return index.compare(JOp[arg], lo, hi, found, mode="device").serialize()
    elif kind == "many32":
        cols, vals, found_cols, qs, ends = many_values()
        index = jbsi.RoaringBitmapSliceIndex()
        index.set_values((cols, vals))
        kw = {"ends": ends} if arg == "RANGE" else {"found_set": JRB(found_cols)}

        def run():
            return index.compare_cardinality_many(JOp[arg], qs, mode="device", **kw).tolist()
    elif kind == "many64":
        cols, vals, qs = many64_values()
        b = JBSI64()
        b.set_values(list(zip(cols.tolist(), vals.tolist())))

        def run():
            return b.compare_cardinality_many(JOp.GE, qs, mode="device").tolist()
    else:  # plan
        expr = JQ.or_(*[JQ.leaf(JRB(v)) for v in plan_values()])
        plain = [s.engine for s in jexec._memo_plan(expr, "device").steps]

        def run():
            sharded = [s.engine for s in jexec._memo_plan(expr, "device").steps]
            return plain, sharded, jexec.execute(expr, cache=None, mode="device").serialize()
    cfg.config.mesh = jsh.make_mesh(8, words_axis=2)
    try:
        _JAX_WANT[case] = run()
    finally:
        cfg.config.mesh = None
    return _JAX_WANT[case]


@pytest.mark.parametrize("op", ["or", "and", "xor"])
@pytest.mark.parametrize("n", WORLDS)
def test_fast_aggregation_through_the_mesh_matches_jax(worlds, n, op):
    assert _case(worlds(n), f"fa[{op}]") == jax_want(f"fa[{op}]")
    assert _case(worlds(n), f"fa_card[{op}]") == jax_want(f"fa_card[{op}]")


@pytest.mark.parametrize("n", WORLDS)
def test_skewed_set_takes_the_unsharded_layout_under_the_mesh(worlds, n):
    got, layouts = _case(worlds(n), "fa_skew[or]")
    assert got == jax_want("fa_skew[or]")
    assert layouts == {"bucketed": 1}


@pytest.mark.parametrize("op", ONEIL_OPS)
@pytest.mark.parametrize("n", WORLDS)
def test_bsi_compare_through_the_mesh_matches_jax(worlds, n, op):
    """K = 3 key chunks: padded with empty chunks on a 2- or 4-wide
    containers axis."""
    from roaringbitmap_tpu_torch import RoaringBitmap

    got, got_card = _case(worlds(n), f"bsi[{op}]")
    assert got == jax_want(f"bsi[{op}]")
    assert got_card == RoaringBitmap.deserialize(got).get_cardinality()


@pytest.mark.parametrize("n", WORLDS)
def test_bsi_sum_through_the_mesh_matches_jax(worlds, n):
    cols, vals, found_cols, _med = bsi_values()
    assert _case(worlds(n), "bsi_sum") == jax_want("bsi_sum") == (int(vals[::3].sum()), len(found_cols))


@pytest.mark.parametrize("op", ["GE", "NEQ", "RANGE"])
@pytest.mark.parametrize("n", WORLDS)
def test_batched_counts_through_the_mesh_match_jax(worlds, n, op):
    """One count-only batch (one ``rb_oneil_counts`` launch on the card) a
    call."""
    got, batches = _case(worlds(n), f"many32[{op}]")
    assert got == jax_want(f"many32[{op}]")
    assert batches == 1


@pytest.mark.parametrize("n", WORLDS)
def test_batched_counts_64_through_the_mesh_match_jax(worlds, n):
    _cols, vals, qs = many64_values()
    got, batches = _case(worlds(n), "many64[GE]")
    assert got == jax_want("many64[GE]") == [int((vals >= q).sum()) for q in qs]
    assert batches == 1


@pytest.mark.parametrize("n", WORLDS)
def test_planner_picks_the_sharded_engine_and_keys_the_memo_on_the_mesh(worlds, n):
    plain, sharded, rekeyed, got = _case(worlds(n), "plan")
    want_plain, want_sharded, want = jax_want("plan")
    assert plain == want_plain == ["device-or"]
    assert sharded == want_sharded == ["device-or-sharded"]
    assert rekeyed
    assert got == want


# ---------------------------------------------------------------------------
# row widths of the reduce, popcount and O'Neil kernels
# ---------------------------------------------------------------------------


NARROW = (1024, 512, 256)


def _width_inputs(device):
    rng = np.random.default_rng(SEED + 7)
    words = torch.from_numpy(_u32(rng, (3, 40, 2048)).view(np.int32)).to(device)
    slices = torch.from_numpy(_u32(rng, (6, 4, 2048)).view(np.int32)).to(device)
    ebm = slices[0] | slices[1] | slices[2]
    fixed = ebm & torch.from_numpy(_u32(rng, (4, 2048)).view(np.int32)).to(device)
    return words, slices, ebm.contiguous(), fixed.contiguous()


def _cut(t, w):
    return t[..., :w].contiguous()


def _oneil_bits(op, q_n, s_count, device):
    walks = 2 if op == "RANGE" else 1
    vals = [(0b101101 * (q + 1)) % (1 << s_count) for q in range(q_n * walks)]
    bits = [bits_high_first(v, s_count) for v in vals]
    return torch.tensor(bits, dtype=torch.int32).reshape(q_n, walks, s_count).to(device)


@pytest.mark.parametrize("w", NARROW)
def test_plain_reduce_and_popcount_at_a_narrow_width_equal_the_full_row_cut(w):
    words, slices, _ebm, fixed = _width_inputs("cpu")
    plan = K.SegmentPlan.dense(3, 40)
    csr = K.SegmentPlan.csr(np.array([0, 7, 7, 120]))
    for op in ("or", "and", "xor"):
        assert torch.equal(K.group_reduce(_cut(words, w), plan, op), _cut(K.group_reduce(words, plan, op), w))
        assert torch.equal(K.group_reduce(_cut(words, w), csr, op), _cut(K.group_reduce(words, csr, op), w))
    zeroed = words.clone()
    zeroed[..., w:] = 0
    assert torch.equal(K.popcount_rows(_cut(words, w)), K.popcount_rows(zeroed))
    masked = slices.clone()
    masked[..., w:] = 0
    assert torch.equal(
        K.popcount_rows(_cut(slices, w), mask=_cut(fixed, w)), K.popcount_rows(masked, mask=fixed)
    )
    red, card = K.wide_reduce_cardinality(_cut(words, w))
    full, _ = K.wide_reduce_cardinality(words)
    assert torch.equal(red, full[:w]) and int(card) == int(K.popcount_rows(full[:w].view(1, -1))[0])


@pytest.mark.parametrize("w", NARROW)
@pytest.mark.parametrize("op", ONEIL_OPS)
def test_plain_oneil_at_a_narrow_width_equals_the_full_row_cut(w, op):
    _words, slices, ebm, fixed = _width_inputs("cpu")
    s_count = slices.shape[0]
    one = _oneil_bits(op, 1, s_count, "cpu")
    out, cards = K.oneil_compare(_cut(slices, w), one, _cut(ebm, w), _cut(fixed, w), op)
    full, _ = K.oneil_compare(slices, one, ebm, fixed, op)
    assert torch.equal(out, _cut(full, w))
    assert torch.equal(cards[0], K.popcount_rows(_cut(full, w)))
    many = _oneil_bits(op, 5, s_count, "cpu")
    _, counts = K.oneil_compare(_cut(slices, w), many, _cut(ebm, w), _cut(fixed, w), op, count_only=True)
    for q in range(5):
        full_q, _ = K.oneil_compare(slices, many[q : q + 1].contiguous(), ebm, fixed, op)
        assert torch.equal(counts[q], K.popcount_rows(_cut(full_q, w)))


@pytest.mark.parametrize("w", [128, 1000, 3072, 4096])
def test_a_width_outside_the_kernels_widths_raises(w):
    rows = torch.zeros((4, w), dtype=torch.int32)
    with pytest.raises(ValueError, match="wide"):
        K.group_reduce(rows, K.SegmentPlan.dense(1, 4))
    with pytest.raises(ValueError, match="wide"):
        K.popcount_rows(rows)
    bits = torch.zeros((1, 1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="wide"):
        K.oneil_compare(rows.view(2, 2, w), bits, rows[:2], rows[:2], "GE")
    with pytest.raises(ValueError):
        K.oneil_tile_plan(32, 4, "GE", row_words=w)


def test_tile_plan_keeps_the_tile_within_the_row():
    for w in K.ROW_WIDTHS:
        for s in (1, 32, 70, K.MAX_TILED_SLICES):
            plan = K.oneil_tile_plan(s, 64, "GE", row_words=w)
            assert plan is not None and plan.tile_words <= w
    assert K.oneil_tile_plan(32, 64, "GE") == K.oneil_tile_plan(32, 64, "GE", row_words=2048)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
def test_cuda_reduce_and_popcount_at_1024_words_equal_the_plain_versions():
    _needs_card()
    words, slices, _ebm, fixed = (_cut(t, 1024) for t in _width_inputs("cuda"))
    for plan in (K.SegmentPlan.dense(3, 40), K.SegmentPlan.csr(np.array([0, 7, 7, 120]))):
        for op in ("or", "and", "xor"):
            assert torch.equal(K.group_reduce(words, plan, op), K.group_reduce_plain(words, plan, op))
    assert torch.equal(K.popcount_rows(words), K.popcount_rows_plain(words))
    assert torch.equal(K.popcount_rows(slices, mask=fixed), K.popcount_rows_plain(slices, mask=fixed))


@pytest.mark.cuda
@pytest.mark.parametrize("op", ONEIL_OPS)
def test_cuda_oneil_at_1024_words_equals_the_plain_version(op):
    _needs_card()
    _words, slices, ebm, fixed = (_cut(t, 1024) for t in _width_inputs("cuda"))
    s_count = slices.shape[0]
    one = _oneil_bits(op, 1, s_count, "cuda")
    got = K.oneil_compare(slices, one, ebm, fixed, op)
    want = K.oneil_compare_plain(slices, one, ebm, fixed, op)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    many = _oneil_bits(op, 20, s_count, "cuda")
    got = K.oneil_compare(slices, many, ebm, fixed, op, count_only=True)[1]
    assert torch.equal(got, K.oneil_compare_plain(slices, many, ebm, fixed, op, True)[1])
