"""The port's fuzz harness (``roaringbitmap_tpu_torch.fuzz``) against the
JAX package's.

The same seed draws the same inputs in both packages: bitmaps, working
sets, mutation sequences, fault schedules (site, kind, trigger),
expression trees, 64-bit bitmaps and crash plans. Every family passes on
the port at the JAX tests' seeds and counts, with its device path on CPU
tensors (``aggregation.config.device = "cpu"``, ``bsi.config.device =
"cpu"``); the campaign runs the JAX campaign's families with its counts;
a planted failure gives both packages the same repro payloads; and the
fault family's departure (the port raises, classified, where the JAX
package degrades) is accepted only for the injected fault at a site of
``fuzz.RAISING_SITES``. The ``cuda``-marked twins run the device
families on the card.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import roaringbitmap_tpu.fuzz as jfuzz
from roaringbitmap_tpu.parallel import store as jstore
from roaringbitmap_tpu.robust import faults as jfaults
from roaringbitmap_tpu.robust import ladder as jladder

import roaringbitmap_tpu_torch.fuzz as tfuzz
from roaringbitmap_tpu_torch import FastAggregation as TFA
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch import query as tq
from roaringbitmap_tpu_torch.models import bsi
from roaringbitmap_tpu_torch.models import immutable as timm
from roaringbitmap_tpu_torch.parallel import aggregation, store
from roaringbitmap_tpu_torch.robust import errors as terrors
from roaringbitmap_tpu_torch.robust import faults as tfaults
from roaringbitmap_tpu_torch.robust import ladder as tladder

REPO = pathlib.Path(__file__).resolve().parent.parent
ITER = 24  # tests/test_fuzz.py's per-invariant count


def _reset():
    for f in (tfaults, jfaults):
        f.clear()
    tladder.LADDER.reset()
    jladder.LADDER.reset()
    store.PACK_CACHE.close()
    jstore.PACK_CACHE.close()
    tq.DEFAULT_CACHE.clear()


@pytest.fixture(autouse=True)
def fuzz_state(monkeypatch):
    """The port's device path on CPU tensors; no armed faults, closed
    breakers and empty pack caches in both packages around each test."""
    monkeypatch.setattr(aggregation.config, "device", "cpu")
    monkeypatch.setattr(bsi.config, "device", "cpu")
    _reset()
    yield
    _reset()


# ---------------------------------------------------------------------------
# the generators: the same seed, the same inputs
# ---------------------------------------------------------------------------


def _bytes(bms):
    return [b.serialize() for b in bms]


def _tree(node):
    """An expression tree as nested tuples, leaves as their bytes."""
    if node.op == "leaf":
        return ("leaf", node.bitmap.serialize())
    return (node.op, node.k, tuple(_tree(c) for c in node.children))


@pytest.mark.parametrize("seed", range(4))
def test_random_bitmaps_are_the_jax_bitmaps(seed):
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    for max_keys, prob in ((4, 0.3), (1, 0.0), (2, 1.0), (6, 0.5)):
        for _ in range(3):
            assert (jfuzz.random_bitmap(rj, max_keys, prob).serialize()
                    == tfuzz.random_bitmap(rt, max_keys, prob).serialize())
    assert rj.random() == rt.random()  # no extra draw on either side


@pytest.mark.parametrize("layout", ["padded", "bucketed", "segmented-scan"])
def test_working_sets_are_the_jax_working_sets(layout):
    rj, rt = np.random.default_rng(31), np.random.default_rng(31)
    for _ in range(2):
        assert _bytes(jfuzz.random_working_set(rj, layout)) == _bytes(
            tfuzz.random_working_set(rt, layout))
    with pytest.raises(ValueError):
        tfuzz.random_working_set(rt, "diagonal")


def test_mutation_sequences_are_the_jax_mutations():
    rj, rt = np.random.default_rng(53), np.random.default_rng(53)
    jb = [jfuzz.random_bitmap(rj) for _ in range(4)]
    tb = [tfuzz.random_bitmap(rt) for _ in range(4)]
    for _ in range(60):
        i = int(rj.integers(0, 4))
        assert i == int(rt.integers(0, 4))
        jfuzz._random_mutation(rj, jb[i])
        tfuzz._random_mutation(rt, tb[i])
        assert jb[i].serialize() == tb[i].serialize()


def _schedule(rules):
    """Schedules compared by site, kind and trigger: the port's
    ``simulated_oom`` builds the CUDA OOM type, the JAX package's its own."""
    return [(site, exc.__name__, kw) for site, exc, kw in rules]


@pytest.mark.parametrize("seed", [55, 57, 58, 59, 60])
def test_fault_schedules_are_the_jax_schedules(seed):
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    kinds = set()
    for _ in range(40):
        js, ts = jfuzz.random_fault_schedule(rj), tfuzz.random_fault_schedule(rt)
        assert _schedule(js) == _schedule(ts)
        kinds |= {name for _s, name, _k in _schedule(ts)}
    assert kinds == {"TransientDeviceError", "ResourceExhausted", "simulated_oom"}
    assert tuple(tfaults.SITES) == tuple(jfaults.SITES)


@pytest.mark.parametrize("seed", [51, 52, 99])
def test_expressions_are_the_jax_expressions(seed):
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    ops = set()
    for _ in range(12):
        n = int(rj.integers(2, 5))
        assert n == int(rt.integers(2, 5))
        jl = [jfuzz.random_bitmap(rj) for _ in range(n)]
        tl = [tfuzz.random_bitmap(rt) for _ in range(n)]
        je, te = jfuzz.random_expression(rj, jl), tfuzz.random_expression(rt, tl)
        assert _tree(je) == _tree(te)
        stack = [te]
        while stack:
            node = stack.pop()
            ops.add(node.op)
            stack.extend(node.children)
    assert "leaf" in ops and len(ops) >= 4


def test_bitmaps64_and_crash_plans_are_the_jax_ones():
    rj, rt = np.random.default_rng(22), np.random.default_rng(22)
    for _ in range(4):
        assert jfuzz.random_bitmap64(rj).serialize() == tfuzz.random_bitmap64(rt).serialize()
    for plan_seed in (0, 7, 61, 4242):
        (jb, jm), (tb, tm) = jfuzz._durable_plan(plan_seed), tfuzz._durable_plan(plan_seed)
        assert _bytes(jb) == _bytes(tb)
        assert [{k: v.tolist() for k, v in m.items()} for m in jm] == [
            {k: v.tolist() for k, v in m.items()} for m in tm]


def test_iterations_knob_is_read_at_call_time(monkeypatch):
    monkeypatch.setenv("ROARINGBITMAP_TPU_FUZZ_ITERATIONS", "7")
    assert tfuzz.default_iterations() == jfuzz.default_iterations() == 7
    monkeypatch.delenv("ROARINGBITMAP_TPU_FUZZ_ITERATIONS")
    assert tfuzz.default_iterations() == 10000


# ---------------------------------------------------------------------------
# every family at the JAX tests' seeds
# ---------------------------------------------------------------------------


def _xor_pred(a, b):
    x = TRB.xor(a, b)
    return TRB.xor(x, b) == a and x == TRB.or_(TRB.andnot(a, b), TRB.andnot(b, a))


def _flip_pred(a):
    c = a.clone()
    c.flip_range(0, 1 << 22)
    c.flip_range(0, 1 << 22)
    return c == a


def _buffer_pred(ma, mb, ha, hb):
    from roaringbitmap_tpu_torch import BufferFastAggregation

    return (
        BufferFastAggregation.or_(ma, mb) == TRB.or_(ha, hb)
        and TRB.and_cardinality(ma, mb) == TRB.and_cardinality(ha, hb)
        and ma.rank_long(123456) == ha.rank_long(123456)
        and ma.serialize() == ha.serialize()
        and isinstance(ma, timm.ImmutableRoaringBitmap)
    )


def _cross64_pred(a, b):
    from roaringbitmap_tpu_torch import Roaring64Bitmap

    aa, bb = Roaring64Bitmap(a.to_array()), Roaring64Bitmap(b.to_array())
    union = a.clone()
    union.ior(b)
    art = Roaring64Bitmap.or_(aa, bb)
    return (union.serialize() == art.serialize()
            and union.get_long_cardinality() == art.get_long_cardinality()
            and a.serialize() == aa.serialize())


FAMILIES = {
    "and-distributes-over-or": lambda: tfuzz.verify_invariance(
        "and-distributes-over-or",
        lambda a, b, c: TRB.and_(a, TRB.or_(b, c)) == TRB.or_(TRB.and_(a, b), TRB.and_(a, c)),
        arity=3, iterations=ITER, seed=1),
    "xor-involution": lambda: tfuzz.verify_invariance(
        "xor-involution", _xor_pred, arity=2, iterations=ITER, seed=2),
    "flip-involution": lambda: tfuzz.verify_invariance(
        "flip-involution", _flip_pred, arity=1, iterations=ITER, seed=7),
    "wide-or-engines-agree": lambda: tfuzz.verify_invariance(
        "wide-or-engines-agree",
        lambda a, b, c: TFA.or_(a, b, c, mode="cpu") == TRB.or_(TRB.or_(a, b), c)
        and TFA.or_(a, b, c, mode="device") == TRB.or_(TRB.or_(a, b), c),
        arity=3, iterations=ITER // 2, seed=8),
    "buffer-heap-equivalence": lambda: tfuzz.verify_buffer_invariance(
        "buffer-heap-equivalence", _buffer_pred, arity=2, iterations=ITER // 2, seed=21),
    "64bit-cross-design": lambda: tfuzz.verify_invariance64(
        "64bit-cross-design", _cross64_pred, arity=2, iterations=ITER // 3, seed=22),
    "device-layouts(or)": lambda: tfuzz.verify_layout_invariance(
        "layouts-vs-engines", op="or", iterations=6, seed=31),
    "device-layouts(xor)": lambda: tfuzz.verify_layout_invariance(
        "layouts-vs-engines", op="xor", iterations=3, seed=32),
    "query-planner-vs-naive": lambda: tfuzz.verify_query_invariance(
        "query-planner-vs-naive", iterations=ITER // 2, seed=51),
    "query-planner-vs-naive(device)": lambda: tfuzz.verify_query_invariance(
        "query-planner-vs-naive(device)", iterations=ITER // 4, seed=52, mode="device"),
    "pack-cache": lambda: tfuzz.verify_pack_cache_invariance(
        "unit-pack-cache", iterations=25, seed=99),
    "columnar": lambda: tfuzz.verify_columnar_invariance(
        "columnar-vs-percontainer", iterations=25, seed=54),
    "fault-schedule": lambda: tfuzz.verify_fault_schedule_invariance(
        "fault-schedule-vs-oracle", iterations=25, seed=55),
    "fusion": lambda: tfuzz.verify_fusion_invariance("pinned", iterations=25, seed=57),
    "serve": lambda: tfuzz.verify_serve_invariance(
        "concurrent-serve-vs-serial", iterations=3, seed=58),
    "epochs": lambda: tfuzz.verify_epoch_invariance(
        "concurrent-ingest-vs-epoch-oracle", iterations=3, seed=59),
    "compaction": lambda: tfuzz.verify_compaction_invariance(
        "compaction-vs-identity-oracle", iterations=3, seed=60),
    "durable-crash": lambda: tfuzz.verify_durable_crash_invariance(
        "crash-at-any-flip-stage-vs-recovery-oracle", iterations=3, seed=61),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_passes_on_the_port(family):
    FAMILIES[family]()


@pytest.mark.parametrize("family", ["fault-schedule", "fusion", "serve", "epochs", "compaction"])
def test_schedule_families_pass_with_every_engine_on_the_device_path(family, monkeypatch):
    """``mode="device"`` sends the fuzz-sized sets through the device
    engines (CPU tensors here), so device sites fire and raise: the
    departure table must cover every escape."""
    monkeypatch.setattr(aggregation.config, "mode", "device")
    FAMILIES[family]()


@pytest.mark.parametrize("seed", [105, 109, 127])
def test_compaction_family_holds_where_a_flip_raises_mid_repack(seed):
    """Seeds whose schedules make a flip raise halfway through its writer
    (``native.entry``): the flip must fail closed, or the corpus diverges
    from the no-compaction twin."""
    tfuzz.verify_compaction_invariance("compaction-vs-identity-oracle", iterations=4, seed=seed)


def test_layout_fuzz_rejects_and():
    with pytest.raises(ValueError, match="decomposable"):
        tfuzz.verify_layout_invariance("bad", op="and", iterations=1, seed=1)


def test_layout_family_asserts_the_dispatcher_choice(monkeypatch):
    real = store.prepare_reduce
    monkeypatch.setattr(store, "prepare_reduce", lambda p, op="or": (real(p, op)[0], "padded"))
    with pytest.raises(tfuzz.InvarianceFailure, match="dispatcher chose padded"):
        tfuzz.verify_layout_invariance("layouts", op="or", iterations=3, seed=31)


# ---------------------------------------------------------------------------
# reporting: a planted failure reproduces in both packages
# ---------------------------------------------------------------------------


def test_planted_failure_gives_both_packages_the_same_repro():
    with pytest.raises(tfuzz.InvarianceFailure) as te:
        tfuzz.verify_invariance("always-false", lambda a: False, arity=1, iterations=1, seed=9)
    with pytest.raises(jfuzz.InvarianceFailure) as je:
        jfuzz.verify_invariance("always-false", lambda a: False, arity=1, iterations=1, seed=9)
    assert te.value.repro == je.value.repro and len(te.value.repro) == 1
    assert str(te.value) == str(je.value)
    bm = tfuzz.reproduce(te.value.repro[0])
    assert bm == tfuzz.random_bitmap(np.random.default_rng(9))


def test_predicate_crash_is_reported():
    def boom(a):
        raise RuntimeError("kaboom")

    with pytest.raises(tfuzz.InvarianceFailure, match="kaboom"):
        tfuzz.verify_invariance("crash", boom, arity=1, iterations=1, seed=10)


# ---------------------------------------------------------------------------
# the campaign: the JAX campaign's families and counts
# ---------------------------------------------------------------------------


def _jax_campaign_counts(n):
    """``{family: iterations}`` of the JAX package's ``run_campaign(n)``,
    read from its source (every ``_run(name, ..., actual=...)`` call)."""
    tree = ast.parse((REPO / "roaringbitmap_tpu" / "fuzz.py").read_text())
    fn = next(f for f in tree.body if isinstance(f, ast.FunctionDef) and f.name == "run_campaign")
    out = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.func.id == "_run":
            actual = next((k.value for k in node.keywords if k.arg == "actual"), None)
            out[node.args[0].value] = n if actual is None else eval(  # noqa: S307 - the literal max(1, n // k) of a repo file
                compile(ast.Expression(actual), "fuzz.py", "eval"), {"max": max, "n": n})
    return out


def test_campaign_has_the_jax_families_and_counts():
    walls = {}
    got = tfuzz.run_campaign(8, verbose=False, device="cpu", walls=walls)
    want = _jax_campaign_counts(8)
    assert len(want) == 31
    assert got == want and list(got) == list(want)
    assert set(walls) == set(want) and all(w >= 0 for w in walls.values())
    assert (aggregation.config.device, bsi.config.device) == ("cpu", "cpu")


def test_campaign_sets_and_restores_the_device(monkeypatch):
    monkeypatch.setattr(aggregation.config, "device", "cuda")
    monkeypatch.setattr(bsi.config, "device", "cuda")
    seen = []
    monkeypatch.setattr(tfuzz, "_campaign", lambda *a: seen.append(
        (aggregation.config.device, bsi.config.device)) or {})
    tfuzz.run_campaign(1, verbose=False, device="cpu")
    assert seen == [("cpu", "cpu")]
    assert (aggregation.config.device, bsi.config.device) == ("cuda", "cuda")
    if not torch.cuda.is_available():
        with pytest.raises(terrors.TierUnavailable):
            tfuzz.run_campaign(1, verbose=False, device="cuda")
        assert seen == [("cpu", "cpu")]


def test_cli_defaults_to_the_card(monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(tfuzz, "run_campaign", lambda n, device=None: calls.append((n, device)) or {"x": 1})
    assert tfuzz.main([]) == 0 and tfuzz.main(["3", "--device", "cpu"]) == 0
    assert calls == [(None, "cuda"), (3, "cpu")]
    with pytest.raises(SystemExit):
        tfuzz.main(["--device", "tpu"])


# ---------------------------------------------------------------------------
# the fault family's departure
# ---------------------------------------------------------------------------


def test_departure_table_is_the_raising_sites():
    assert set(tfuzz.RAISING_SITES) <= set(tfaults.SITES)
    # the sites that degrade, fail open or fail closed are not in it
    assert not {"query.hedge", "serve.admit", "epoch.flip", "pack_cache.budget",
                "serve.maintain", "durable.persist"} & set(tfuzz.RAISING_SITES)


@pytest.mark.parametrize("exc", [terrors.TransientDeviceError, terrors.ResourceExhausted,
                                 terrors.simulated_oom])
def test_departure_accepts_only_the_injected_fault_at_a_raising_site(exc):
    with tfaults.inject("store.ship", exc, every=1) as fired, \
            tfaults.inject("pack_cache.budget", exc, every=1) as budget:
        with pytest.raises(Exception) as ei:
            tfaults.fault_point("store.ship")
        armed = [("store.ship", exc, fired), ("pack_cache.budget", exc, budget)]
        assert tfuzz._departure(ei.value, armed)
        # the same fault at a site that is not in the table
        with pytest.raises(Exception) as eb:
            tfaults.fault_point("pack_cache.budget")
        assert not tfuzz._departure(eb.value, [("pack_cache.budget", exc, budget)])
        # an exception of the class that no rule raised
        assert not tfuzz._departure(terrors.TransientDeviceError("per-container tier failed"), armed)
        assert not tfuzz._departure(ValueError("injected fault at site 'store.ship'"), armed)
    with tfaults.inject("store.ship", exc, every=1) as unfired:
        assert not tfuzz._departure(ei.value, [("store.ship", exc, unfired)])


def test_fault_family_fails_on_a_planted_wrong_result(monkeypatch):
    real = tq.execute

    def wrong(expr, *a, **kw):
        out = real(expr, *a, **kw).clone()
        out.add(0xFFFFFFFF)
        return out

    monkeypatch.setattr(tq, "execute", wrong)
    with pytest.raises(tfuzz.InvarianceFailure, match="fault-schedule result diverged"):
        tfuzz.verify_fault_schedule_invariance("fault-schedule-vs-oracle", iterations=25, seed=55)


@pytest.mark.parametrize("exc", [terrors.TransientDeviceError("per-container tier failed"),
                                 RuntimeError("per-container tier failed")])
def test_fault_family_fails_on_a_raise_from_a_cpu_tier(exc, monkeypatch):
    def boom(*_a, **_kw):
        raise exc

    # every CPU tier of the aggregation's list raises: the escape is not
    # an injected fault at a raising site
    monkeypatch.setattr(aggregation, "_percontainer_aggregate", boom)
    monkeypatch.setattr(aggregation, "_pure_python_fold", boom)
    from roaringbitmap_tpu_torch import columnar

    monkeypatch.setattr(columnar, "fold", boom)
    with pytest.raises(tfuzz.InvarianceFailure, match="exception escaped the ladder"):
        tfuzz.verify_fault_schedule_invariance("fault-schedule-vs-oracle", iterations=25, seed=55)


@pytest.mark.parametrize("pkg", [tfaults, jfaults], ids=["port", "jax"])
def test_inject_after_builds_the_exception_at_the_firing_hit(pkg):
    """The crash family's child dies in the injected exception's
    constructor, so ``inject(after=k)`` must build it at hit k + 1 and not
    before."""
    built = []

    class PowerCut(BaseException):
        def __init__(self, *args):
            built.append(args)
            super().__init__(*args)

    with pkg.inject("durable.persist", PowerCut, after=2):
        pkg.fault_point("durable.persist")
        pkg.fault_point("durable.persist")
        assert built == []
        with pytest.raises(PowerCut):
            pkg.fault_point("durable.persist")
    assert len(built) == 1


def test_durable_child_takes_its_device_as_an_argument():
    assert "sys.argv[4]" in (REPO / "roaringbitmap_tpu_torch" / "fuzz.py").read_text()
    src = ast.parse((REPO / "roaringbitmap_tpu_torch" / "fuzz.py").read_text())
    child = next(f for f in src.body if isinstance(f, ast.FunctionDef) and f.name == "_durable_child")
    assert [a.arg for a in child.args.args] == ["root", "plan_seed", "kill_hit", "device"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _on_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the families' device steps launch the kernels")
    monkeypatch.setattr(aggregation.config, "device", "cuda")
    monkeypatch.setattr(bsi.config, "device", "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("op,iterations,seed", [("or", 6, 31), ("xor", 3, 32)])
def test_layout_family_on_the_card(op, iterations, seed, monkeypatch):
    _on_card(monkeypatch)
    tfuzz.verify_layout_invariance("layouts-vs-engines", op=op, iterations=iterations, seed=seed)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["pack-cache", "query-planner-vs-naive(device)",
                                    "wide-or-engines-agree", "durable-crash"])
def test_device_family_on_the_card(family, monkeypatch):
    _on_card(monkeypatch)
    FAMILIES[family]()


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["fault-schedule", "fusion", "serve", "epochs", "compaction"])
def test_schedule_family_on_the_card(family, monkeypatch):
    _on_card(monkeypatch)
    monkeypatch.setattr(aggregation.config, "mode", "device")
    FAMILIES[family]()
