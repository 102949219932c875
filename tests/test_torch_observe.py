"""The port's observability (``roaringbitmap_tpu_torch.observe`` and
``tracing``) against the JAX package's.

Registry, histogram and ``CounterMap`` semantics are held in both
packages; the same sequence of metric operations on a private registry of
each gives byte-identical Prometheus and JSONL exports; the flight
recorder's modes, ring bound, Chrome export and dump on anomaly; the off
mode allocates no span; spans nest; decisions and outcomes resolve. On a
census-shaped working set (a few hundred bitmaps of the seeded census
stand-in) and on Q1 both packages record the same decision sites,
choices and non-timing attributes, and the same layout and pack-cache
deltas, but for the andnot's subtrahend pack, which the port keys without
the minuend. The port's device path runs on CPU tensors
(``aggregation.config.device = "cpu"``), the JAX package's on its CPU
backend.
"""

import importlib
import json
import threading
import time

import numpy as np
import pytest
import torch

import roaringbitmap_tpu.observe as jobs
from roaringbitmap_tpu import query as jq
from roaringbitmap_tpu.models.roaring import RoaringBitmap as JRB
from roaringbitmap_tpu.observe import decisions as jdec
from roaringbitmap_tpu.observe import export as jexport
from roaringbitmap_tpu.observe import outcomes as jout
from roaringbitmap_tpu.parallel import store as jstore
from roaringbitmap_tpu.parallel.aggregation import FastAggregation as JFA

import roaringbitmap_tpu_torch.observe as tobs
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch import insights, tracing
from roaringbitmap_tpu_torch import query as tq
from roaringbitmap_tpu_torch.observe import compilewatch
from roaringbitmap_tpu_torch.observe import decisions as tdec
from roaringbitmap_tpu_torch.observe import export as texport
from roaringbitmap_tpu_torch.observe import outcomes as tout
from roaringbitmap_tpu_torch.observe import spans as tspans
from roaringbitmap_tpu_torch.observe import timeline as tl
from roaringbitmap_tpu_torch.ops import kernels as K
from roaringbitmap_tpu_torch.parallel import aggregation, store
from roaringbitmap_tpu_torch.parallel.aggregation import FastAggregation as TFA
from roaringbitmap_tpu_torch.utils import datasets

# the package attribute ``observe.histogram`` is the registration helper;
# the module is reached through the import system
thist = importlib.import_module("roaringbitmap_tpu_torch.observe.histogram")
jhist = importlib.import_module("roaringbitmap_tpu.observe.histogram")

SEED = 0xFEEF1F0
PKGS = {"port": tobs, "jax": jobs}
HIST = {"port": thist, "jax": jhist}


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    """The port's device path on CPU tensors; both packages' caches and
    decision logs emptied around each test, the timeline off after it."""
    monkeypatch.setattr(aggregation.config, "device", "cpu")
    for c in (store.PACK_CACHE, jstore.PACK_CACHE):
        c.close()
    tq.DEFAULT_CACHE.clear()
    yield
    tl.configure(mode="off", budget_ms=0)
    tl.RECORDER.clear()
    for c in (store.PACK_CACHE, jstore.PACK_CACHE):
        c.close()
    tq.DEFAULT_CACHE.clear()


# ---------------------------------------------------------------------------
# registry, histogram and CounterMap semantics, in both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_counter_gauge_histogram_semantics(pkg):
    o = PKGS[pkg]
    reg = o.Registry()
    c = reg.counter("rb_tpu_t_total", "a counter", ("k",))
    c.inc(2, ("a",))
    c.inc(labels={"k": "a"})
    assert c.get(("a",)) == 3 and c.get(("b",)) == 0
    with pytest.raises(o.MetricError):
        c.inc(-1, ("a",))
    with pytest.raises(o.MetricError):
        c.inc(1, ("a", "b"))
    assert reg.counter("rb_tpu_t_total", "a counter", ("k",)) is c  # idempotent
    with pytest.raises(o.MetricError):
        reg.gauge("rb_tpu_t_total", "", ("k",))  # a conflicting kind is loud
    g = reg.gauge("rb_tpu_t_bytes", "", ("kind",))
    g.set(10, ("x",))
    g.inc(5, ("x",))
    g.dec(12, ("x",))
    assert g.get(("x",)) == 3
    h = reg.histogram("rb_tpu_t_seconds", "", ("s",), buckets=(0.1, 1.0))
    for v in (0.05, 0.1, 0.5, 3.0):
        h.observe(v, ("p",))
    st = h.get(("p",))
    assert st["count"] == 4 and st["slots"] == [2, 1, 1]
    snap = reg.snapshot()["rb_tpu_t_seconds"]["samples"][0]
    assert snap["buckets"] == {"0.1": 2, "1": 3, "+Inf": 4}
    reg.reset()
    assert c.get(("a",)) == 0 and reg.get("rb_tpu_t_total") is c  # definitions stay


@pytest.mark.parametrize("pkg", PKGS)
def test_countermap_reads_like_a_counter(pkg):
    o = PKGS[pkg]
    reg = o.Registry()
    scalar = o.CounterMap(reg.counter("rb_tpu_s_total", "", ("layout",)), scalar=True)
    scalar["padded"] += 1
    scalar["padded"] += 2
    assert scalar["padded"] == 3 and scalar["missing"] == 0
    assert "missing" not in scalar and dict(scalar) == {"padded": 3}
    del scalar["padded"]
    assert len(scalar) == 0
    pair = o.CounterMap(reg.counter("rb_tpu_p_total", "", ("kind", "engine")))
    pair[("grouped", "a")] = 4
    assert dict(pair.items()) == {("grouped", "a"): 4}
    pair.clear()
    assert len(pair) == 0


def test_countermap_fixed_labels_view_one_slice():
    reg = tobs.Registry()
    m = reg.counter("rb_tpu_kernel_t_total", "", ("kind", "engine"))
    launches = tobs.CounterMap(m, scalar=True, fixed={"engine": "cuda"})
    m.inc(2, ("rb_threshold", "cuda"))
    m.inc(5, ("rb_threshold", "plain"))
    launches["rb_expand_rows"] += 1
    assert dict(launches) == {"rb_threshold": 2, "rb_expand_rows": 1}
    assert m.get(("rb_expand_rows", "cuda")) == 1
    launches.clear()  # clears its own slice only
    assert m.series() == {("rb_threshold", "plain"): 5}
    with pytest.raises(ValueError):
        tobs.CounterMap(m, scalar=True, fixed={"nope": "x"})


def test_launches_is_a_view_of_the_dispatch_counter():
    before = dict(K.LAUNCHES)
    assert set(before) == set(K.KERNELS)
    plain = K._DISPATCH_TOTAL.get(("rb_popcount_rows", "plain"))
    K.popcount_rows(torch.zeros(3, 2048, dtype=torch.int32))
    assert K.LAUNCHES == before  # a CPU tensor: the plain version, no launch
    assert K._DISPATCH_TOTAL.get(("rb_popcount_rows", "plain")) == plain + 1
    kernel = insights.dispatch_counters()["kernel"]
    assert kernel["rb_popcount_rows/plain"] == plain + 1
    assert insights.dispatch_counters()["probes"] == {}


@pytest.mark.parametrize("pkg", PKGS)
def test_latency_quantiles_land_within_one_bucket(pkg):
    h = HIST[pkg].latency_histogram("rb_tpu_q_seconds", "", ("k",), registry=PKGS[pkg].Registry())
    vals = np.abs(np.random.default_rng(7).lognormal(-6.0, 1.8, 4000))
    for v in vals:
        h.observe(float(v), ("a",))
    for q in (0.5, 0.9, 0.99):
        est, true = h.quantile(q, ("a",)), float(np.percentile(vals, q * 100))
        assert true / 1.34 <= est <= true * 1.34
    with pytest.raises(PKGS[pkg].MetricError):
        HIST[pkg].latency_histogram("rb_tpu_bad_total", registry=PKGS[pkg].Registry())


def test_log_buckets_equal_the_jax_package():
    assert thist.log_time_buckets() == jhist.log_time_buckets()
    assert thist.log_time_buckets(1e-4, 10.0, 4) == jhist.log_time_buckets(1e-4, 10.0, 4)


def _drive(o, hist, seed):
    """One seeded sequence of metric operations on a fresh registry."""
    rng = np.random.default_rng(seed)
    reg = o.Registry()
    c = reg.counter("rb_tpu_kernel_dispatch_total", "Kernel calls", ("kind", "engine"))
    g = reg.gauge("rb_tpu_store_resident_bytes", 'bytes "held"\nnow', ("kind",))
    h = reg.histogram("rb_tpu_host_op_seconds", "phases", ("name",))
    lat = hist.latency_histogram("rb_tpu_store_pack_stage_seconds", "stages", ("stage",), registry=reg)
    reg.counter("rb_tpu_unused_total", "never touched", ("x",))
    for _ in range(200):
        r = int(rng.integers(4))
        label = ["a", "b", 'q"uote', "new\\line"][int(rng.integers(4))]
        v = float(rng.lognormal(-5, 2))
        if r == 0:
            c.inc(int(rng.integers(1, 5)), (label, ["cuda", "plain"][int(rng.integers(2))]))
        elif r == 1:
            g.set(int(rng.integers(0, 1 << 30)), (label,))
        elif r == 2:
            h.observe(v, (label,))
        else:
            lat.observe(v, (label,))
    return reg


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_exports_are_byte_identical_to_the_jax_package(seed):
    t = _drive(tobs, thist, seed)
    j = _drive(jobs, jhist, seed)
    assert texport.prometheus_text(t) == jexport.prometheus_text(j)
    assert texport.to_jsonl(t) == jexport.to_jsonl(j)
    assert t.snapshot() == j.snapshot()


def test_write_exports_and_sidecar(tmp_path):
    reg = _drive(tobs, thist, 4)
    texport.write_prometheus(str(tmp_path / "m.prom"), reg)
    texport.write_jsonl(str(tmp_path / "m.jsonl"), reg)
    assert (tmp_path / "m.prom").read_text() == texport.prometheus_text(reg)
    lines = (tmp_path / "m.jsonl").read_text().splitlines()
    assert all(json.loads(ln)["name"].startswith("rb_tpu_") for ln in lines)
    with pytest.raises(RuntimeError):
        with texport.metrics_sidecar(str(tmp_path / "side.json"), reg):
            raise RuntimeError("the run failed; the sidecar is written anyway")
    side = json.loads((tmp_path / "side.json").read_text())
    assert side["schema"] == texport.SIDECAR_SCHEMA == jexport.SIDECAR_SCHEMA
    assert side["probes"] == {} and side["kernel"]
    assert "rb_tpu_store_pack_stage_seconds" in side["latency"]


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------


def test_off_mode_allocates_no_span(monkeypatch):
    tl.configure(mode="off")

    def boom(*a, **k):
        raise AssertionError("a span object was built with the timeline off")

    monkeypatch.setattr(tl, "_Span", boom)
    monkeypatch.setattr(tl, "TimelineEvent", boom)
    monkeypatch.setattr(tl.RECORDER, "record", boom)
    bms = [TRB(np.arange(i, 40_000 + i, 9)) for i in range(8)]
    assert TFA.or_(*bms, mode="device") == TFA.or_(*bms, mode="cpu")
    bms[0].add(123_457)
    TFA.or_(*bms, mode="device")  # the delta route
    assert tl.tspan("a", "b") is tl.tspan("c", "d") is tl._NULL


@pytest.mark.parametrize("mode", ["on", "fenced"])
def test_modes_record_spans_instants_and_stages(mode):
    tl.configure(mode=mode)
    tl.RECORDER.clear()
    bms = [TRB(np.arange(i, 60_000 + i, 7)) for i in range(6)]
    with tobs.trace_scope() as scope:
        got = TFA.or_(*bms, mode="device")
        x = torch.ones(3)
        assert tl.fence(x) is x  # a CPU tensor needs no fence
    assert got == TFA.or_(*bms, mode="cpu")
    assert tl.fenced() == (mode == "fenced")
    names = {e.name for e in tl.RECORDER.events()}
    assert {"agg.device", "ladder.attempt", "pack.payload_build", "pack.ship",
            "pack.device_expand", "decision.agg.dispatch", "pack_cache.miss"} <= names
    assert {e.trace for e in tl.RECORDER.events() if e.name == "agg.device"} == {scope.trace_id}


def test_ring_keeps_the_newest_window():
    rec = tl.FlightRecorder(capacity=8)
    for i in range(20):
        rec.record(tl.TimelineEvent(f"e{i}", "t", "i", i, 0, 1, None))
    assert [e.name for e in rec.events()] == [f"e{i}" for i in range(12, 20)]
    assert len(rec) == 8 and rec.total() == 20 and rec.dropped() == 12
    rec.resize(4)
    assert [e.name for e in rec.events()] == ["e16", "e17", "e18", "e19"]
    with pytest.raises(ValueError):
        tl.FlightRecorder(0)


def test_chrome_trace_parses_and_names_threads(tmp_path):
    tl.configure(mode="on")
    tl.RECORDER.clear()
    with tl.tspan("outer", "host", rows=3):
        tl.instant("mark", "event", k=1)
    fid = tl.flow_id("q1", "key")
    tl.flow_point("handoff", "s", fid)
    tl.flow_point("handoff", "f", fid)
    path = tmp_path / "trace.json"
    tl.write_chrome_trace(str(path), meta={"run": "test"})
    trace = json.loads(path.read_text())
    evs = trace["traceEvents"]
    assert trace["otherData"] == {"run": "test"}
    spans = [e for e in evs if e["ph"] == "X"]
    assert spans[0]["name"] == "outer" and spans[0]["args"] == {"rows": 3}
    assert {e["ph"] for e in evs} >= {"X", "i", "s", "f", "M"}
    assert all(e["id"] == fid for e in evs if e["ph"] in ("s", "f"))
    assert tl.stage_totals(tl.RECORDER.events(), ["outer"])["outer"] > 0


def test_dump_on_anomaly_lands_in_the_sink(tmp_path):
    dump = tmp_path / "anomaly.jsonl"
    tl.configure(mode="on", budget_ms=0.0001, dump_path=str(dump))
    tl.RECORDER.clear()
    before = tobs.REGISTRY.get(tobs.TIMELINE_ANOMALY_TOTAL).get(("slow",))
    with tl.tspan("slow.step", "slow"):
        time.sleep(0.002)
    tl.configure(budget_ms=0)
    deadline = time.time() + 5.0
    while not dump.is_file() and time.time() < deadline:
        time.sleep(0.01)
    lines = [json.loads(ln) for ln in dump.read_text().splitlines()]
    assert lines[0]["schema"] == tl.DUMP_SCHEMA
    assert lines[0]["trigger"]["span"] == "slow.step"
    assert any(e["name"] == "slow.step" for e in lines[1:])
    assert tobs.REGISTRY.get(tobs.TIMELINE_ANOMALY_TOTAL).get(("slow",)) == before + 1


def test_artifact_sink_resolves_bare_names(tmp_path):
    from roaringbitmap_tpu_torch.observe import artifacts

    prev = artifacts.artifact_dir()
    artifacts.configure(dir=str(tmp_path / "sink"))
    try:
        assert artifacts.resolve("x.jsonl") == str(tmp_path / "sink" / "x.jsonl")
        assert (tmp_path / "sink").is_dir()
        assert artifacts.resolve(str(tmp_path / "a" / "y.jsonl")) == str(tmp_path / "a" / "y.jsonl")
    finally:
        artifacts.configure(dir=prev)


def test_spans_nest_and_op_timer_records():
    tracing.reset_timings()
    with tobs.span("outer") as p1:
        with tracing.op_timer("inner"):
            assert tspans.current_path() == "outer/inner" and tspans.depth() == 2
    assert p1 == "outer" and tspans.depth() == 0
    assert tobs.span_timings()["outer/inner"]["count"] == 1
    assert tracing.timings()["inner"]["count"] == 1
    with pytest.raises(KeyError):
        with tobs.span("boom"):
            raise KeyError
    assert tspans.depth() == 0


def test_spans_are_thread_local():
    seen = {}

    def work(name):
        with tobs.span(name):
            time.sleep(0.01)
            seen[name] = tspans.current_path()

    threads = [threading.Thread(target=work, args=(f"t{i}",)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert seen == {f"t{i}": f"t{i}" for i in range(4)}


def test_tracing_trace_writes_a_chrome_trace(tmp_path):
    with tracing.trace(str(tmp_path / "prof")) as prof:
        with tracing.annotate("rb.annotated"):
            torch.ones(64).sum()
    trace = json.loads((tmp_path / "prof" / tracing.TRACE_FILE).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "rb.annotated" in names
    assert any(e.key == "rb.annotated" for e in prof.key_averages())


def test_compilewatch_counts_tracked_builds():
    compilewatch.reset_counts()
    calls = []

    @compilewatch.tracked("rb_test_lib")
    def build():
        calls.append(1)
        return "built"

    assert build() == "built" and build() == "built"
    assert compilewatch.compile_counts() == {"rb_test_lib": 2}
    compilewatch.reset_counts()


# ---------------------------------------------------------------------------
# decisions and outcomes
# ---------------------------------------------------------------------------


def test_decisions_and_outcomes_resolve():
    tdec.LOG.clear()
    tout.reset()
    with tobs.trace_scope() as scope:
        seq = tdec.record_decision("t.site", "fast", outcome=True, est_us={"fast": 10.0, "slow": 5.0})
    entry = tdec.decisions(1)[0]
    assert entry["seq"] == seq and entry["trace"] == scope.trace_id
    assert entry["inputs"]["est_us"]["fast"] == 10.0
    joined = tout.resolve(seq, "t.site", 20e-6, engine="fast")
    assert joined["error_ratio"] == pytest.approx(0.5)
    assert joined["regret_s"] == pytest.approx(15e-6)  # the slow engine was priced to win
    assert tout.summary()["t.site"]["count"] == 1
    orphans = tobs.REGISTRY.get(tobs.OUTCOME_ORPHANS_TOTAL).get(("t.site",))
    assert tout.resolve(seq, "t.site", 1.0) is None  # resolved once only
    assert tobs.REGISTRY.get(tobs.OUTCOME_ORPHANS_TOTAL).get(("t.site",)) == orphans + 1
    seq2 = tdec.record_decision("t.site", "slow", outcome=True)
    with tout.measure(seq2, "t.site", engine="slow"):
        time.sleep(0.001)
    assert tout.tail(1)[0]["seq"] == seq2 and tout.tail(1)[0]["measured_s"] > 0
    assert insights.decisions(2)[-1]["seq"] == seq2
    assert insights.outcomes(1)[0]["seq"] == seq2
    tdec.configure(enabled=False)
    try:
        assert tdec.record_decision("t.site", "x") is None
    finally:
        tdec.configure(enabled=True)


def test_planner_refits_from_the_live_ledger():
    from roaringbitmap_tpu_torch.query.plan import CardinalityModel

    tout.reset()
    bms = [TRB(np.arange(i, 30_000 + i, 3 + i)) for i in range(6)]
    expr = tq.Q.and_(*[tq.Q.leaf(b) for b in bms])
    for _ in range(4):
        tq.execute(expr, cache=None, mode="cpu")
        tq.exec._PLAN_MEMO.clear()  # a fresh plan, a fresh decision to resolve
    model = CardinalityModel()
    report = model.refit_from_outcomes()  # default: the live ledger
    assert "and" in report["moved"] and model.provenance == "refit-from-traffic"
    assert tdec.decisions(1)[0]["site"] == "costmodel.refit"


# ---------------------------------------------------------------------------
# the census-shaped path and Q1, against the JAX package
# ---------------------------------------------------------------------------

# decision sites the port records (the JAX package's serving sites come
# with the serving tier). ``columnar.cutoff`` is compared in
# test_torch_columnar.py: on a device dispatch the JAX package also builds
# its CPU fallback chain, whose fold gate records a verdict the port's
# device-only tier list never makes (ROADMAP, departures).
PORT_SITES = {"agg.dispatch", "query.plan", "pack_cache.admit", "pack_cache.evict",
              "ladder.degrade", "ladder.breaker", "fusion.batch"}


def _census(n=240):
    base, _real = datasets.load_or_synthesize("census1881")
    vals = [np.asarray(base[i % 60], dtype=np.uint32) for i in range(n)]
    return [TRB(v) for v in vals], [JRB(v) for v in vals]


def _decisions_of(dec_mod, outcomes_mod, columnar_mod):
    out = []
    for e in dec_mod.decisions():
        if e["site"] not in PORT_SITES:
            continue
        inputs = dict(e.get("inputs") or {})
        if "fold_gate" in inputs:
            # the gate each package's own cost model holds (calibrated or
            # not by earlier tests in this process)
            assert inputs.pop("fold_gate") == columnar_mod.MODEL.fold_gate_rows()
        # the cache's running total counts the flat rows once in the port,
        # twice in the JAX package (host words at admission, device rows
        # on expansion)
        inputs.pop("cache_bytes", None)
        out.append((e["site"], e["decision"], inputs))
    return out


def _cache_delta(cache, before):
    st = cache.stats()
    return {k: st[k] - before[k] for k in ("hits", "misses", "delta_rows")}


def _as_the_port_packs_the_andnot(decisions, delta, subtrahend_rows, resident):
    """The JAX package's records of one device andnot, as the port makes
    them. The JAX package keys the andnot's pack by its minuend and
    subtrahends, so a new minuend misses and admits an ``andnot`` entry
    (first's covered rows and the subtrahends' rows on them). The port
    keys the subtrahends alone: their aggregation entry of every
    subtrahend row (``subtrahend_rows``), admitted once, then hit by an
    andnot with any minuend (``resident``)."""
    admits = [i for i, (site, _d, inputs) in enumerate(decisions)
              if site == "pack_cache.admit" and inputs.get("kind") == "andnot"]
    assert len(admits) == 1
    out = list(decisions)
    if resident:
        del out[admits[0]]
        delta = {**delta, "hits": delta["hits"] + 1, "misses": delta["misses"] - 1}
    else:
        site, decision, _inputs = out[admits[0]]
        out[admits[0]] = (site, decision, {"kind": "agg", "bytes": subtrahend_rows * store.ROW_BYTES})
    return out, delta


def _jax_andnot_counts():
    """The JAX package's (hits, misses) of kind ``andnot``."""
    return [jstore._PACK_HITS.get(("andnot",)), jstore._PACK_MISSES.get(("andnot",))]


def _run_both(t_fn, j_fn, andnot=None):
    """Run both, compare their records and return the port's; ``andnot``,
    ``(subtrahend_rows, resident)``, maps the JAX package's records of one
    device andnot to the port's keying (``_as_the_port_packs_the_andnot``)."""
    from roaringbitmap_tpu import columnar as jcol
    from roaringbitmap_tpu_torch import columnar as tcol

    tdec.LOG.clear()
    jdec.LOG.clear()
    t_lay, j_lay = dict(store.LAYOUT_COUNTS), dict(jstore.LAYOUT_COUNTS)
    t_st, j_st = store.PACK_CACHE.stats(), jstore.PACK_CACHE.stats()
    j_kind = _jax_andnot_counts()
    got, want = t_fn(), j_fn()
    assert got.serialize() == want.serialize()
    j_decisions = _decisions_of(jdec, jout, jcol)
    j_delta = _cache_delta(jstore.PACK_CACHE, j_st)
    if andnot is not None:
        # the JAX package's own records, before any mapping: its andnot
        # lookup misses (a new minuend), cold or warm
        assert [n - b for n, b in zip(_jax_andnot_counts(), j_kind)] == [0, 1]
        j_decisions, j_delta = _as_the_port_packs_the_andnot(j_decisions, j_delta, *andnot)
    assert _decisions_of(tdec, tout, tcol) == j_decisions
    assert {k: v - t_lay.get(k, 0) for k, v in store.LAYOUT_COUNTS.items()} == {
        k: jstore.LAYOUT_COUNTS.get(k, 0) - j_lay.get(k, 0) for k in store.LAYOUT_COUNTS
    }
    assert _cache_delta(store.PACK_CACHE, t_st) == j_delta
    return _decisions_of(tdec, tout, tcol)


def test_census_path_records_what_the_jax_package_records():
    tb, jb = _census()
    for _ in range(2):  # cold, then warm on the resident pack
        seen = _run_both(lambda: TFA.or_(*tb, mode="device"), lambda: JFA.or_(*jb, mode="device"))
        assert seen[0][:2] == ("agg.dispatch", "device")
    _run_both(lambda: TFA.xor(*tb[:-1], mode="device"), lambda: JFA.xor(*jb[:-1], mode="device"))
    tb[7].add(5)
    jb[7].add(5)
    _run_both(lambda: TFA.or_(*tb, mode="device"), lambda: JFA.or_(*jb, mode="device"))  # delta
    seen = _run_both(lambda: TFA.or_(*tb, mode="cpu"), lambda: JFA.or_(*jb, mode="cpu"))
    assert seen[0][1] in ("columnar-cpu", "per-container")


def test_q1_records_what_the_jax_package_records():
    tb, jb = _census(201)
    thirds = ((0, 67), (67, 134), (134, 201))

    def q1(Q, bms):
        a, b, c = ([Q.leaf(bms[i]) for i in range(lo, hi)] for lo, hi in thirds)
        head = [Q.leaf(x) for x in bms[:8]]
        return Q.or_(Q.andnot(Q.and_(Q.or_(*a), Q.or_(*b)), Q.or_(*c)), Q.threshold(2, *head))

    tx, jx = q1(tq.Q, tb), q1(jq.Q, jb)
    c_rows = sum(b.get_container_count() for b in tb[thirds[2][0]:thirds[2][1]])
    cold = _run_both(
        lambda: tq.execute(tx, cache=None, mode="device"),
        lambda: jq.execute(jx, cache=None, mode="device"),
        andnot=(c_rows, False),
    )
    steps = tq.exec._memo_plan(tx, "device").steps
    assert [d for s, d, _i in cold if s == "query.plan"] == [st.engine for st in steps]
    assert "device-or" in {st.engine for st in steps}
    warm = _run_both(  # the plan memoized: no planner decision, packs resident
        lambda: tq.execute(tx, cache=None, mode="device"),
        lambda: jq.execute(jx, cache=None, mode="device"),
        andnot=(c_rows, True),
    )
    assert "query.plan" not in {s for s, _d, _i in warm}
    assert {s for s, _d, _i in warm} >= {"agg.dispatch"}
    assert insights.query_counters()["plan"]["device-or"] >= 3


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["on", "fenced"])
def test_cuda_timeline_keeps_the_bytes_and_counts_the_launches(mode, monkeypatch):
    """On the card: the OR with the timeline on or fenced equals the CPU
    device path's bytes, its decision resolves on the device, and the
    registry's launch deltas equal ``LAUNCHES``. Skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    tb, _jb = _census(120)
    want = TFA.or_(*tb, mode="device", device="cpu").serialize()
    monkeypatch.setattr(aggregation.config, "device", "cuda")
    K.reset_launches()
    tout.reset()
    tl.configure(mode=mode)
    got = [TFA.or_(*tb, mode="device").serialize() for _ in range(2)]
    tl.configure(mode="off")
    assert got == [want, want]
    launches = dict(K.LAUNCHES)
    assert launches == {k: K._DISPATCH_TOTAL.get((k, "cuda")) for k in K.KERNELS}
    assert launches["rb_expand_rows"] == 1 and launches["rb_popcount_rows"] == 2
    joined = [e for e in tout.tail() if e["site"] == "agg.dispatch"]
    assert len(joined) == 2 and all(e["engine"] == "device" for e in joined)


# ---------------------------------------------------------------------------
# the sidecar and insights surfaces of this slice, against the JAX package
# ---------------------------------------------------------------------------

# every sidecar block of the JAX package has its counterpart (the
# ``analysis`` block came with the port's analyzer)
UNPORTED_BLOCKS = set()


def test_sidecar_blocks_are_the_jax_blocks_less_the_unported():
    from roaringbitmap_tpu.observe import export as jexport

    got = set(tobs.sidecar_snapshot())
    want = set(jexport.sidecar_snapshot())
    assert got == want - UNPORTED_BLOCKS
    assert {"health", "fusion", "serving", "pairwise", "lock_wait", "hbm_drift", "serial_bytes",
            "epochs", "structure", "durable"} <= got


def test_insights_surfaces_have_the_jax_shapes():
    from roaringbitmap_tpu import insights as jinsights

    assert set(insights.columnar_counters()) == set(jinsights.columnar_counters())
    assert set(insights.regret_summary()) == set(jinsights.regret_summary())
    assert set(insights.regret_summary()["provenance"]) == set(jinsights.regret_summary()["provenance"])
    assert set(insights.health()) == set(jinsights.health())
    assert set(insights.fusion_counters()) == set(jinsights.fusion_counters())
    assert set(insights.observatory()) == set(jinsights.observatory())
    for panel in ("epochs", "structure", "durable"):
        assert set(getattr(insights, panel)()) == set(getattr(jinsights, panel)())
    assert set(insights.serving()) == set(jinsights.serving())
    assert insights.cost_authorities()["schema"] == jinsights.cost_authorities()["schema"]
    assert set(insights.cost_authorities()["authorities"]) == set(
        jinsights.cost_authorities()["authorities"])
    model = insights.columnar_costmodel()
    assert set(model) == set(jinsights.columnar_costmodel())


@pytest.mark.parametrize("seed", [0, 1])
def test_serving_block_on_a_private_registry_is_the_jax_block(seed):
    """``export._serving_block`` is a pure function of a registry: the
    same per-tenant series on a private registry of each package give the
    same block."""
    from roaringbitmap_tpu.observe.histogram import latency_histogram as jlat
    from roaringbitmap_tpu_torch.observe.histogram import latency_histogram as tlat

    rng = np.random.default_rng(seed)
    script = [(str(rng.choice(["a", "b", "c"])), str(rng.choice(["queue", "execute"])),
               float(rng.lognormal(-5, 1.5))) for _ in range(80)]
    blocks = []
    for o, export, lat in ((tobs, texport, tlat), (jobs, jexport, jlat)):
        reg = o.Registry()
        h = lat(o.SERVE_LATENCY_SECONDS, "", ("tenant", "phase"), registry=reg)
        for tenant, phase, s in script:
            h.observe(s, (tenant, phase))
        for name, labels, value in ((o.SERVE_QPS, ("a",), 12.4), (o.SERVE_TENANT_BYTES, ("b",), 8192),
                                    (o.SERVE_SATURATION_RATIO, ("c",), 0.75),
                                    (o.SERVE_SLO_BUDGET_SECONDS, ("a",), 0.025)):
            reg.gauge(name, "", ("tenant",)).set(value, labels)
        adm = reg.counter(o.SERVE_ADMIT_TOTAL, "", ("tenant", "verdict"))
        req = reg.counter(o.SERVE_REQUESTS_TOTAL, "", ("tenant", "outcome"))
        for tenant, verdict in (("a", "admit"), ("a", "shed"), ("b", "queue"), ("a", "admit")):
            adm.inc(1, (tenant, verdict))
            req.inc(1, (tenant, "ok" if verdict != "shed" else "shed"))
        reg.gauge(o.SERVE_QUEUE_COUNT, "").set(3)
        reg.gauge(o.SERVE_INFLIGHT_COUNT, "").set(7)
        blocks.append(export._serving_block(reg.snapshot(), reg))
    assert blocks[0] == blocks[1]
    assert blocks[0]["queue_depth"] == 3 and blocks[0]["inflight"] == 7
    assert set(blocks[0]["tenants"]) == {"a", "b", "c"}


def test_new_metric_names_are_the_jax_names():
    from roaringbitmap_tpu.observe import registry as jreg
    from roaringbitmap_tpu_torch.observe import registry as treg

    names = {k: v for k, v in vars(treg).items() if k.isupper() and isinstance(v, str)
             and v.startswith("rb_tpu_")}
    assert names and all(getattr(jreg, k) == v for k, v in names.items())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_serial_bytes_count_the_same_bytes_as_the_jax_package(seed):
    """``rb_tpu_serial_bytes_total{direction}``: serializing and parsing the
    same bitmaps moves both packages' counters by the same bytes, and the
    sidecar's ``serial_bytes`` block reports them."""
    from roaringbitmap_tpu import serialization as jser
    from roaringbitmap_tpu.models.roaring import RoaringBitmap as JRB
    from roaringbitmap_tpu_torch import RoaringBitmap as TRB
    from roaringbitmap_tpu_torch import serialization as tser

    rng = np.random.default_rng(seed)
    vals = [np.sort(rng.choice(1 << 20, int(rng.integers(1, 20000)), replace=False)).astype(np.uint32)
            for _ in range(6)]
    vals.append(np.arange(3 << 16, (3 << 16) + 90000, dtype=np.uint32))
    moved = {}
    for label, RB, ser, export in (("port", TRB, tser, texport), ("jax", JRB, jser, jexport)):
        bms = [RB(v) for v in vals]
        bms[-1].run_optimize()
        before = export.sidecar_snapshot()["serial_bytes"]
        blobs = [b.serialize() for b in bms]
        for blob in blobs:
            ser.read_into(RB(), blob)
        after = export.sidecar_snapshot()["serial_bytes"]
        moved[label] = ({k: after[k] - before.get(k, 0) for k in after}, blobs)
    assert moved["port"] == moved["jax"]
    total = sum(len(b) for b in moved["port"][1])
    assert moved["port"][0] == {"serialize": total, "deserialize": total}


def test_registry_names_are_the_jax_names_less_the_probe_and_analysis():
    """Every canonical ``rb_tpu_*`` name of the JAX registry is in the
    port's, with the same value, except ``KERNEL_PROBE_TOTAL`` (the port
    never probes for a lowering); the ``ANALYSIS_*`` names came with the
    port's analyzer, and the port has no name of its own."""
    from roaringbitmap_tpu.observe import registry as jreg
    from roaringbitmap_tpu_torch.observe import registry as treg

    def names(mod):
        return {k: v for k, v in vars(mod).items()
                if k.isupper() and isinstance(v, str) and v.startswith("rb_tpu_")}

    t, j = names(treg), names(jreg)
    missing = set(j) - set(t)
    assert missing == {"KERNEL_PROBE_TOTAL"}
    assert set(t) <= set(j) and all(t[k] == j[k] for k in t)
    exported = {k for k in dir(tobs) if k in t}
    assert exported == set(t)
