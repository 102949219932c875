"""The port's serving write path against the JAX package.

The ingest log (submit, depth gauge, drain, merge, apply), the epoch
flip's four outcomes, its lineage records and ``delta`` blocks over warm
working sets, the freshness histogram under a fake clock, reader pinning
across a flip, the ``epoch.flip`` fault failing closed, the priced
``maybe_flip`` verdict, the harness's write schedule with the epoch-replay
oracle, and maintenance passes (outcomes, the identity audit, reclaimed
bytes, rewritten keys) — each held against the JAX package on the same
seeded numpy inputs, exactly. Batch ids come from a process-wide counter
in each package, so both counters restart at 1 around every test; flip
walls are the only masked field. The port's device path runs on CPU
tensors (``aggregation.config.device = "cpu"``); the ``cuda``-marked cases
flip a working set while the overlap lane stages on the card, and while a
reader's device copy of the resident rows is still in flight (with each
ordering mechanism stubbed in turn), and skip here.
"""

import itertools
import threading

import numpy as np
import pytest
import torch

from roaringbitmap_tpu.cost import compaction as jcomp_cost
from roaringbitmap_tpu.cost import epoch as jepoch_cost
from roaringbitmap_tpu.models.roaring import RoaringBitmap as JRB
from roaringbitmap_tpu.observe import decisions as jdec
from roaringbitmap_tpu.observe import export as jexport
from roaringbitmap_tpu.observe import outcomes as jout
from roaringbitmap_tpu.observe import structure as jstruct
from roaringbitmap_tpu.parallel import store as jstore
from roaringbitmap_tpu.robust import faults as jfaults
from roaringbitmap_tpu.robust import ladder as jladder
from roaringbitmap_tpu.robust.errors import TransientDeviceError as JTransient
from roaringbitmap_tpu import serve as jserve
from roaringbitmap_tpu.serve import epochs as jepochs
from roaringbitmap_tpu.serve import ingest as jingest
from roaringbitmap_tpu.serve import maintain as jmaintain
from roaringbitmap_tpu.serve import slo as jslo

from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch import insights as tinsights
from roaringbitmap_tpu_torch import observe as tobs
from roaringbitmap_tpu_torch import query as tq
from roaringbitmap_tpu_torch import serve as tserve
from roaringbitmap_tpu_torch.cost import compaction as tcomp_cost
from roaringbitmap_tpu_torch.cost import epoch as tepoch_cost
from roaringbitmap_tpu_torch.observe import decisions as tdec
from roaringbitmap_tpu_torch.observe import export as texport
from roaringbitmap_tpu_torch.observe import outcomes as tout
from roaringbitmap_tpu_torch.observe import structure as tstruct
from roaringbitmap_tpu_torch.observe import timeline as ttl
from roaringbitmap_tpu_torch.parallel import aggregation, overlap, store
from roaringbitmap_tpu_torch.robust import faults as tfaults
from roaringbitmap_tpu_torch.robust import ladder as tladder
from roaringbitmap_tpu_torch.robust.errors import TransientDeviceError as TTransient
from roaringbitmap_tpu_torch.serve import epochs as tepochs
from roaringbitmap_tpu_torch.serve import ingest as tingest
from roaringbitmap_tpu_torch.serve import maintain as tmaintain
from roaringbitmap_tpu_torch.serve import slo as tslo


class Side:
    """One package's modules under one name."""

    def __init__(self, label, RB, serve, epochs, ingest, maintain, slo, store, struct,
                 faults, transient, dec, out, export, epoch_cost, comp_cost):
        self.label, self.RB, self.serve, self.epochs = label, RB, serve, epochs
        self.ingest, self.maintain, self.slo, self.store = ingest, maintain, slo, store
        self.struct, self.faults, self.transient, self.dec = struct, faults, transient, dec
        self.out, self.export, self.epoch_cost, self.comp_cost = out, export, epoch_cost, comp_cost

    def packed(self, bitmaps):
        if self.label == "port":
            return self.store.packed_for(bitmaps, device="cpu")
        return self.store.packed_for(bitmaps)


PORT = Side("port", TRB, tserve, tepochs, tingest, tmaintain, tslo, store, tstruct, tfaults,
            TTransient, tdec, tout, texport, tepoch_cost, tcomp_cost)
JAX = Side("jax", JRB, jserve, jepochs, jingest, jmaintain, jslo, jstore, jstruct, jfaults,
           JTransient, jdec, jout, jexport, jepoch_cost, jcomp_cost)
BOTH = (PORT, JAX)


def _reset():
    for s in BOTH:
        s.slo.reset()
        s.out.reset()
        s.dec.LOG.clear()
        s.faults.clear()
        s.epoch_cost.MODEL.reset()
        s.comp_cost.MODEL.reset()
        s.struct.LEDGER.reset()
        s.maintain.reset()
        s.store.PACK_CACHE.close()
    tladder.LADDER.reset()
    jladder.LADDER.reset()
    tq.DEFAULT_CACHE.clear()


@pytest.fixture(autouse=True)
def epoch_state(monkeypatch):
    """The port's device path on CPU tensors; both packages' tenants,
    ledgers, authorities, fault rules and pack caches empty, and both batch
    id counters restarted, around each test."""
    monkeypatch.setattr(aggregation.config, "device", "cpu")
    for s in BOTH:
        monkeypatch.setattr(s.ingest, "_BATCH_IDS", itertools.count(1))
    _reset()
    yield
    _reset()


def _values(n=6, seed=3, card=1200):
    rng = np.random.default_rng(seed)
    return [np.sort(rng.choice(1 << 18, card, replace=False)).astype(np.uint32) for _ in range(n)]


def _declare(side, name="ep-t"):
    side.slo.TENANTS.declare(name, quota_qps=1e9, burst=1e9)
    return name


def _mask(rec):
    """A flip or pass record without its walls (the only timed fields)."""
    if isinstance(rec, dict):
        return {k: _mask(v) for k, v in rec.items() if k != "wall_s"}
    if isinstance(rec, list):
        return [_mask(v) for v in rec]
    return rec


def _in_keys(bm_values, rng, n):
    """``n`` fresh values inside the chunk keys ``bm_values`` already has
    (mutations of resident containers: the delta route)."""
    keys = np.unique(bm_values >> 16)
    k = int(rng.choice(keys))
    return (k << 16) | rng.choice(1 << 16, n, replace=False).astype(np.int64)


# ---------------------------------------------------------------------------
# the ingest log
# ---------------------------------------------------------------------------


def test_ingest_log_submit_drain_merge_and_apply_match_the_jax_package():
    vals = _values(5, seed=11)
    rng = np.random.default_rng(4)
    script = [{int(i): rng.choice(1 << 20, 30).astype(np.int64) for i in rng.choice(5, 2, replace=False)}
              for _ in range(6)]
    out = {}
    for s in BOTH:
        t = _declare(s)
        log = s.ingest.IngestLog(max_batches=8)
        ids = [log.submit(t, m, stamp=float(i)).batch_id for i, m in enumerate(script)]
        assert log.submit(t, {0: []}) is None  # an empty set mints no batch
        depth = (log.depth(), log.pending_values(), log.total(), log.stamps())
        with pytest.raises(KeyError):
            log.submit("undeclared", {0: [1]})
        with pytest.raises(ValueError):
            log.submit(t, {0: [1 << 32]})
        batches = log.drain()
        merged = s.ingest.merge_batches(batches)
        corpus = [s.RB(v) for v in vals]
        touched = s.ingest.apply_batches(corpus, batches)
        with pytest.raises(IndexError):
            s.ingest.apply_merged(corpus, {99: np.array([1])})
        out[s.label] = (ids, depth, log.depth(), {k: v.tolist() for k, v in merged.items()},
                        touched, [b.serialize() for b in corpus])
    assert out["port"] == out["jax"]
    assert tobs.REGISTRY.get(tobs.SERVE_MUTLOG_COUNT).get(()) == 0


def test_ingest_log_bound_raises_in_both_packages():
    for s in BOTH:
        t = _declare(s)
        log = s.ingest.IngestLog(max_batches=2)
        log.submit(t, {0: [1]})
        log.submit(t, {0: [2]})
        with pytest.raises(OverflowError):
            log.submit(t, {0: [3]})
        with pytest.raises(ValueError):
            s.ingest.IngestLog(max_batches=0)


# ---------------------------------------------------------------------------
# the flip
# ---------------------------------------------------------------------------


def _flip_outcome(s, outcome, vals):
    t = _declare(s)
    corpus = [s.RB(v) for v in vals]
    es = s.epochs.EpochStore(corpus, drain_timeout_s=0.05, clock=lambda: 50.0)
    if outcome != "noop":
        es.submit(t, {1: np.array([7, 9])}, stamp=40.0)
    if outcome == "aborted":
        with s.faults.inject("epoch.flip", s.transient("boom"), every=1):
            rec = es.flip(reason="test")
    elif outcome == "stalled":
        pin = es.reader()
        rec = es.flip(reason="test")
        pin.release()
    else:
        rec = es.flip(reason="test")
    return (_mask(rec), es.current(), es.log.depth(), es.stats(), _mask(es.lineage()),
            [b.serialize() for b in corpus])


@pytest.mark.parametrize("outcome", ["flipped", "noop", "aborted", "stalled"])
def test_flip_outcomes_match_the_jax_package(outcome):
    vals = _values(4)
    got = _flip_outcome(PORT, outcome, vals)
    want = _flip_outcome(JAX, outcome, vals)
    assert got == want
    assert got[0]["outcome"] == outcome
    if outcome != "flipped":
        assert got[1] == 0 and got[5] == [TRB(v).serialize() for v in vals]
    assert tobs.REGISTRY.get(tobs.SERVE_EPOCH_FLIP_TOTAL).get((outcome,)) >= 1


def _lineage_run(s, vals, seed, warm=True):
    t = _declare(s)
    corpus = [s.RB(v) for v in vals]
    fake = [100.0]
    es = s.epochs.EpochStore(corpus, clock=lambda: fake[0])
    n = len(corpus)
    sets = [range(0, n // 2), range(n // 2, n), range(n)]
    for ws in sets:
        es.register_working_set(ws)
        if warm:
            s.packed([corpus[i] for i in ws])
    rng = np.random.default_rng(seed)
    routes = []
    for step in range(5):
        idx = int(rng.integers(0, n))
        if step == 3:  # a fresh chunk key: a structural change, the full route
            muts = {idx: np.array([(200 + step) << 16 | 5])}
        else:
            muts = {idx: _in_keys(vals[idx], rng, int(rng.integers(1, 6))),
                    (idx + 1) % n: _in_keys(vals[(idx + 1) % n], rng, 2)}
        es.submit(t, muts, stamp=fake[0] - 1.0)
        fake[0] += 2.0
        rec = es.flip(reason=f"step{step}")
        routes.append(s.store.PACK_CACHE.last_route())
    return _mask(es.lineage()), routes, [b.serialize() for b in corpus]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lineage_and_delta_records_equal_the_jax_package(seed):
    """Five flips over three warm working sets: every record — batch ids,
    touched bitmaps, values, ts and the ``delta`` block — equals the JAX
    package's. A mutation inside resident chunk keys takes the delta
    route in both (exact lengths take no power-of-two padding that would
    hide a delta); a fresh chunk key takes the full route in both."""
    vals = _values(8, seed=20 + seed)
    got = _lineage_run(PORT, vals, seed)
    want = _lineage_run(JAX, vals, seed)
    assert got[0] == want[0]
    assert got[2] == want[2]
    deltas = [r["delta"] for r in got[0]]
    assert all(d["full_repacks"] == 0 for i, d in enumerate(deltas) if i != 3)
    assert deltas[3]["full_repacks"] >= 1
    assert all(d["delta_rows"] > 0 for i, d in enumerate(deltas) if i != 3)
    assert got[1] == want[1]


def test_cold_sets_flip_through_the_full_route_in_both_packages():
    vals = _values(6, seed=5)
    got = _lineage_run(PORT, vals, 7, warm=False)
    want = _lineage_run(JAX, vals, 7, warm=False)
    assert got[0] == want[0]
    assert got[0][0]["delta"]["full_repacks"] == got[0][0]["delta"]["working_sets"] > 0


def test_freshness_histogram_under_a_fake_clock_matches_the_jax_package():
    vals = _values(4)
    series = {}
    for s in BOTH:
        t = _declare(s, "fresh-port-t")  # a tenant no JAX test reads
        fake = [100.0]
        es = s.epochs.EpochStore([s.RB(v) for v in vals], clock=lambda: fake[0])
        es.submit(t, {0: np.array([1])}, stamp=95.0)
        es.submit(t, {1: np.array([2])}, stamp=99.0)
        es.flip()
        fake[0] = 130.0
        es.submit(t, {2: np.array([3])}, stamp=129.5)
        es.flip()
        series[s.label] = s.ingest.FRESHNESS.series()[(t,)]
    assert series["port"] == series["jax"]
    assert series["port"]["count"] == 3 and series["port"]["sum"] == pytest.approx(6.5)


def test_flip_stages_land_in_the_histogram_and_the_timeline():
    t = _declare(PORT)
    es = tepochs.EpochStore([TRB(v) for v in _values(4)])
    hist = tobs.REGISTRY.get(tobs.SERVE_FLIP_STAGE_SECONDS)
    before = {st: (hist.series().get((st,)) or {"count": 0})["count"] for st in tepochs.FLIP_STAGES}
    prev = ttl.mode_name()
    ttl.configure(mode="on")
    ttl.RECORDER.clear()
    try:
        es.submit(t, {0: np.array([3])})
        es.flip()
    finally:
        ttl.configure(mode=prev)
    assert tepochs.FLIP_STAGES == jepochs.FLIP_STAGES
    for st in tepochs.FLIP_STAGES:
        assert hist.series()[(st,)]["count"] == before[st] + 1
    names = [e.name for e in ttl.RECORDER.events()]
    for span in ("epoch.flip", "epoch.drain", "epoch.repack", "epoch.publish", "epoch.reclaim"):
        assert span in names
    pub = next(e for e in ttl.RECORDER.events() if e.name == "epoch.publish")
    assert pub.attrs["epoch"] == 1


def test_reader_pin_holds_the_flip_and_each_reader_sees_its_own_epoch():
    """A reader pinned to epoch 0 reads epoch-0 bits while a flip waits on
    it; the flip publishes after the release, and a reader admitted then
    reads epoch-1 bits — both equal to the JAX package's answers over its
    own epochs."""
    vals = _values(4, seed=8)
    t = _declare(PORT)
    corpus = [TRB(v) for v in vals]
    es = tepochs.EpochStore(corpus)
    store.packed_for(corpus, device="cpu")
    es.submit(t, {0: _in_keys(vals[0], np.random.default_rng(1), 40)})
    done = threading.Event()
    box = {}
    with es.reader() as pin:
        th = threading.Thread(target=lambda: (box.setdefault("rec", es.flip()), done.set()),
                              daemon=True)
        th.start()
        assert not done.wait(0.15) and es.current() == 0
        before = tq.execute(tq.Q.or_(*corpus), cache=None).serialize()
        assert pin.epoch == 0
    assert done.wait(10.0) and box["rec"]["outcome"] == "flipped"
    with es.reader() as pin2:
        assert pin2.epoch == 1
        after = tq.execute(tq.Q.or_(*corpus), cache=None).serialize()
    jt = _declare(JAX)
    jc = [JRB(v) for v in vals]
    jes = jepochs.EpochStore(jc)
    from roaringbitmap_tpu.query import Q as JQ
    from roaringbitmap_tpu.query import execute as jexecute

    assert jexecute(JQ.or_(*jc), cache=None).serialize() == before
    jes.submit(jt, {0: _in_keys(vals[0], np.random.default_rng(1), 40)})
    jes.flip()
    assert jexecute(JQ.or_(*jc), cache=None).serialize() == after
    assert before != after


@pytest.mark.parametrize("kind", ["transient", "fatal"])
def test_epoch_flip_fault_fails_closed_in_both_packages(kind):
    vals = _values(4)
    out = {}
    for s in BOTH:
        t = _declare(s)
        corpus = [s.RB(v) for v in vals]
        es = s.epochs.EpochStore(corpus)
        es.submit(t, {0: np.array([1])})
        exc = s.transient("boom") if kind == "transient" else ValueError("bug")
        with s.faults.inject("epoch.flip", exc, every=1):
            if kind == "fatal":
                with pytest.raises(ValueError):
                    es.flip()
                rec = None
            else:
                rec = es.flip()
        kept = (es.current(), es.log.depth(), corpus[0].contains(1))
        after = es.flip()
        out[s.label] = (rec, kept, after["outcome"], corpus[0].contains(1))
    assert out["port"] == out["jax"]
    assert out["port"][1] == (0, 1, False) and out["port"][2] == "flipped"


def _dec_rows(s, site):
    return [(d["decision"], {k: v for k, v in d["inputs"].items() if k != "est_us"})
            for d in s.dec.decisions() if d["site"] == site]


def test_maybe_flip_verdicts_match_the_jax_package():
    vals = _values(4)
    out = {}
    for s in BOTH:
        t = _declare(s)
        fake = [1000.0]
        es = s.epochs.EpochStore([s.RB(v) for v in vals], clock=lambda: fake[0])
        first = es.maybe_flip(now=1000.0)  # nothing pending
        es.submit(t, {0: np.array([1])}, stamp=1000.0)
        fresh = es.maybe_flip(now=1000.0001)
        stale = es.maybe_flip(now=1030.0)
        joined = [e for e in s.out.tail() if e["site"] == "epoch.flip"]
        out[s.label] = (first, fresh, _mask(stale), _dec_rows(s, "epoch.flip"),
                        [(j["engine"], j["predicted_us"]) for j in joined])
    assert out["port"] == out["jax"]
    assert out["port"][1]["outcome"] == "accumulate" and out["port"][2]["outcome"] == "flipped"


def test_drain_timeout_stalls_and_reopens_admission_in_both_packages():
    for s in BOTH:
        t = _declare(s)
        es = s.epochs.EpochStore([s.RB(v) for v in _values(4)], drain_timeout_s=0.05)
        es.submit(t, {0: np.array([1])})
        pin = es.reader()
        assert es.flip()["outcome"] == "stalled" and es.stats()["flipping"] is False
        with es.reader() as tk:
            assert tk.epoch == 0
        pin.release()
        assert es.flip()["outcome"] == "flipped"


def test_a_device_fault_at_the_drain_propagates_and_reopens_admission(monkeypatch):
    """A device fault that surfaces at the drain's synchronize (where the
    readers' asynchronous faults come out) propagates from the flip, and
    admission stays open: a later reader is admitted, and a later flip
    publishes the batch the failed one left in the log."""
    t = _declare(PORT)
    es = tepochs.EpochStore([TRB(v) for v in _values(4)])
    es.submit(t, {0: np.array([1])})

    def fault():
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(tepochs, "_quiesce_device", fault)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        es.flip()
    assert es.stats()["flipping"] is False and es.log.depth() == 1
    with es.reader(timeout_s=1) as tk:
        assert tk.epoch == 0
    monkeypatch.setattr(tepochs, "_quiesce_device", lambda: None)
    assert es.flip()["outcome"] == "flipped" and es.current() == 1 and es.log.depth() == 0


_APPLY_MERGED = tingest.apply_merged


def _partial_apply(corpus, merged):
    """The writer applied to the first touched bitmap, then a host-tier
    fault (the port's ``native.entry`` raises where the JAX package falls
    back to numpy)."""
    first = dict(list(merged.items())[:1])
    _APPLY_MERGED(corpus, first)
    raise TTransient("injected fault at site 'native.entry'")


def _repack_fault(self, touched):
    raise RuntimeError("CUDA error: an illegal memory access was encountered")


@pytest.mark.parametrize("where", ["writer", "repack", "fatal"])
def test_a_flip_that_raises_in_its_repack_stage_fails_closed(where, monkeypatch):
    """A raise inside the repack stage (a device fault of the working-set
    refresh, a host-tier fault halfway through the writer) propagates, and
    the corpus is the old epoch's bit for bit: the touched containers are
    put back, a retryable failure's batches return to the log and the next
    flip publishes them, a fatal one's are dropped. The fuzz family
    ``compaction-vs-identity-oracle`` found the torn corpus at seeds 105,
    109 and 127."""
    t = _declare(PORT)
    vals = _values(4)
    corpus = [TRB(v) for v in vals]
    es = tepochs.EpochStore(corpus)
    store.packed_for(corpus, device="cpu").device_words  # resident: the refresh patches rows
    before = [b.serialize() for b in corpus]
    muts = {0: np.arange(10, 60_000, 7), 2: np.array([(40 << 16) + 5, 7])}
    es.submit(t, muts)
    with monkeypatch.context() as m:
        if where == "writer":
            m.setattr(tingest, "apply_merged", _partial_apply)
            raised = TTransient
        elif where == "repack":
            m.setattr(tepochs.EpochStore, "_repack_working_sets", _repack_fault)
            raised = RuntimeError
        else:
            m.setattr(tepochs.EpochStore, "_repack_working_sets",
                      lambda self, touched: (_ for _ in ()).throw(ValueError("bad batch")))
            raised = ValueError
        with pytest.raises(raised):
            es.flip()
    assert [b.serialize() for b in corpus] == before
    assert es.current() == 0 and not [r for r in es.lineage() if r["outcome"] == "flipped"]
    with es.reader() as tk:  # admission reopened on the old epoch
        assert tk.epoch == 0
    # the resident pack revalidates against the restored containers
    assert np.array_equal(store.packed_for(corpus, device="cpu").device_words,
                          store.pack_groups(store.group_by_key(corpus), device="cpu").device_words)
    if where == "fatal":
        assert es.log.depth() == 0 and es.flip()["outcome"] == "noop"
        return
    assert es.log.depth() == 1
    assert es.flip()["outcome"] == "flipped" and es.current() == 1
    want = [TRB(v) for v in vals]
    tingest.apply_merged(want, tingest.merge_batches([tingest.MutationBatch(t, muts)]))
    assert [b.serialize() for b in corpus] == [b.serialize() for b in want]


def test_store_guards_and_restore_match_the_jax_package():
    for s in BOTH:
        with pytest.raises(ValueError):
            s.epochs.EpochStore([])
        es = s.epochs.EpochStore([s.RB(v) for v in _values(4)])
        with pytest.raises(ValueError):
            es.register_working_set([])
        with pytest.raises(IndexError):
            es.register_working_set([9])
        es.register_working_set(range(4))  # the default already covers it
        assert es.stats()["working_sets"] == 1
        es.restore(5, [{"epoch": 5, "parent": 4}])
        assert es.current() == 5 and es.lineage()[-1]["epoch"] == 5
        with pytest.raises(ValueError):
            es.restore(6, [])
        assert s.epochs.current_store() is es
    assert tserve.current_store is tepochs.current_store


# ---------------------------------------------------------------------------
# the harness's write half and the epoch-replay oracle
# ---------------------------------------------------------------------------


def _rw_profiles(serve):
    return [
        serve.TenantProfile("rw-r", weight=3.0, quota_qps=1e6, burst=1e6),
        serve.TenantProfile("rw-w", weight=1.0, quota_qps=1e6, burst=1e6, writes=0.5),
    ]


def _schedule(reqs, corpus):
    idx_of = {id(b): i for i, b in enumerate(corpus)}

    def canon(e):
        if e.op == "leaf":
            return ("leaf", idx_of[id(e.bitmap)])
        return (e.op, e.k, tuple(canon(c) for c in e.children))

    return [(r.idx, r.tenant, r.kind, None if r.expr is None else canon(r.expr),
             None if r.mutations is None else {k: v.tolist() for k, v in r.mutations.items()})
            for r in reqs]


@pytest.mark.parametrize("seed", [99, 5])
def test_write_schedule_and_the_epoch_replay_oracle_match_the_jax_package(seed):
    """The same read-write schedule in both packages; the port's harness
    runs it on 4 threads over an epoch store; the port's
    ``run_serial_epochs`` over a clone and the JAX package's, replaying the
    port run's admitted epochs over its own clone, both equal every served
    result byte for byte."""
    vals = _values(6, seed=7)
    tc, tclone, jclone = [TRB(v) for v in vals], [TRB(v) for v in vals], [JRB(v) for v in vals]
    tprof, jprof = _rw_profiles(tserve), _rw_profiles(jserve)
    treqs = tserve.build_requests(tc, tprof, 30, seed=seed)
    tclone_reqs = tserve.build_requests(tclone, tprof, 30, seed=seed)
    jclone_reqs = jserve.build_requests(jclone, jprof, 30, seed=seed)
    assert _schedule(treqs, tc) == _schedule(jclone_reqs, jclone)
    es = tserve.EpochStore(tc)
    h = tserve.LoadHarness(tc, tprof, threads=4, window=4,
                           admission=tserve.AdmissionController(max_inflight=8, queue_limit=64),
                           epoch_store=es)
    report = h.run(treqs)
    assert report.writes > 0 and report.shed == 0 and report.epoch_start == 0
    assert es.log.depth() == 0  # the run-end flip made every batch queryable
    want = tserve.LoadHarness.run_serial_epochs(tclone_reqs, tclone, report)
    jreport = jserve.HarnessReport(
        jclone_reqs, [None] * len(jclone_reqs), {}, 1.0, epochs=report.epochs,
        batch_ids=report.batch_ids, lineage=report.lineage, epoch_start=report.epoch_start)
    jwant = jserve.LoadHarness.run_serial_epochs(jclone_reqs, jclone, jreport)
    for pos, (g, w, jw) in enumerate(zip(report.results, want, jwant)):
        if isinstance(g, tuple):
            assert g == w == jw and g[0] == "write"
        else:
            assert g.serialize() == w.serialize() == jw.serialize(), f"position {pos}"
    assert [b.serialize() for b in tc] == [b.serialize() for b in tclone] == \
        [b.serialize() for b in jclone]
    for pos, r in enumerate(treqs):
        assert (report.epochs[pos] is not None) == (r.kind == "query")
        assert (report.batch_ids[pos] is not None) == (r.kind == "write")


def test_harness_requires_an_epoch_store_over_its_corpus_in_both_packages():
    for s in BOTH:
        corpus = [s.RB(v) for v in _values(4)]
        with pytest.raises(ValueError):
            s.serve.LoadHarness(corpus, [s.serve.TenantProfile("w", quota_qps=10, writes=0.5)],
                                threads=1)
        with pytest.raises(ValueError):
            s.serve.LoadHarness(corpus, [s.serve.TenantProfile("r", quota_qps=10)], threads=1,
                                epoch_store=s.serve.EpochStore([s.RB(v) for v in _values(4)]))
        h = s.serve.LoadHarness(corpus, [s.serve.TenantProfile("r", quota_qps=10)], threads=1)
        reqs = s.serve.build_requests(corpus, [s.serve.TenantProfile("w", quota_qps=10, writes=1.0)],
                                      3, seed=1)
        with pytest.raises(ValueError):
            h.run_serial(reqs)


# ---------------------------------------------------------------------------
# maintenance passes
# ---------------------------------------------------------------------------


def _drifted_values(n=5, seed=12):
    """Bitmaps with drifted containers: long runs stored as bitmap and
    array containers (no run_optimize), beside random ones."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        runs = np.arange((i << 16) + 100, (i << 16) + 100 + int(rng.integers(5000, 20000)))
        short = np.arange((7 << 16) + 10, (7 << 16) + 10 + int(rng.integers(200, 900)))
        noise = rng.choice(1 << 20, 300, replace=False)
        out.append(np.unique(np.concatenate([runs, short, noise])).astype(np.uint32))
    return out


def _pass_run(s, vals, outcome):
    t = _declare(s)
    corpus = [s.RB(v) for v in vals]
    fake = [10.0]
    es = s.epochs.EpochStore(corpus, clock=lambda: fake[0])
    s.packed(corpus)
    if outcome != "noop":
        s.struct.LEDGER.watch("corpus", corpus)
    rng = np.random.default_rng(3)
    es.submit(t, {1: _in_keys(vals[1], rng, 3)}, stamp=9.0)
    es.flip(now=10.0)
    es.submit(t, {2: _in_keys(vals[2], rng, 4)}, stamp=9.5)
    if outcome == "aborted":
        with s.faults.inject("serve.maintain", s.transient("boom"), every=1):
            rec = s.maintain.run_pass(es, reason="test", now=11.0)
    elif outcome == "rode":
        s.comp_cost.MODEL.coeffs["pass_overhead_us"] = 1e12
        rec = s.maintain.run_pass(es, reason="test", now=11.0)
    else:
        rec = s.maintain.run_pass(es, reason="test", force=True, now=11.0)
    before = s.struct.LEDGER.stats() if s.struct.LEDGER.watched() else None
    return (_mask(rec), _dec_rows(s, "serve.maintain"), s.maintain.last_pass() and
            _mask(s.maintain.last_pass()), [b.serialize() for b in corpus], before,
            es.current(), es.log.depth())


@pytest.mark.parametrize("outcome", ["compacted", "rode", "aborted", "noop"])
def test_maintenance_pass_outcomes_match_the_jax_package(outcome):
    vals = _drifted_values()
    got = _pass_run(PORT, vals, outcome)
    want = _pass_run(JAX, vals, outcome)
    assert got == want
    rec = got[0]
    assert rec["outcome"] == outcome
    if outcome == "compacted":
        assert rec["rewritten_keys"] > 0 and rec["reclaimed_bytes"] > 0
        assert rec["anomalies"] == 0 and rec["audited"] == rec["rewritten_keys"]
        assert rec["flip"]["delta"]["full_repacks"] == 0


def test_compaction_keeps_every_value_and_lowers_the_drift():
    vals = _drifted_values(seed=19)
    t = _declare(PORT)
    corpus = [TRB(v) for v in vals]
    es = tepochs.EpochStore(corpus)
    store.packed_for(corpus, device="cpu")
    tstruct.LEDGER.watch("corpus", corpus)
    drift0 = tstruct.LEDGER.refresh()["drift_ratio"]
    want = tq.execute(tq.Q.or_(*corpus), cache=None)
    rec = tmaintain.run_pass(es, force=True)
    assert rec["outcome"] == "compacted" and rec["anomalies"] == 0 and rec["rewritten_keys"] > 0
    assert [b.to_array().tolist() for b in corpus] == [v.tolist() for v in vals]
    got = tq.execute(tq.Q.or_(*corpus), cache=None)
    assert got.serialize() == want.serialize()
    assert rec["flip"]["delta"]["full_repacks"] == 0 and rec["flip"]["delta"]["delta_rows"] > 0
    assert tstruct.LEDGER.stats()["drift_ratio"] < drift0
    assert tstruct.LEDGER.stats()["accretion_depth"] == 0


def test_a_lossy_rewrite_is_dropped_as_an_anomaly_in_both_packages(monkeypatch):
    """The identity audit: a rewrite that changes content is refused (the
    old container stays) and counted, the same way in both packages."""
    from roaringbitmap_tpu.models import container as jcont
    from roaringbitmap_tpu_torch.models import container as tcont

    vals = _drifted_values(3, seed=2)
    out = {}
    for s, cont in ((PORT, tcont), (JAX, jcont)):
        real = cont.BitmapContainer.run_optimize

        def lossy(self, _real=real, _cont=cont):
            new = _real(self)
            if new is self:
                return new
            return _cont.ArrayContainer(np.array([1, 2, 3], dtype=np.uint16))

        monkeypatch.setattr(cont.BitmapContainer, "run_optimize", lossy)
        _declare(s)
        corpus = [s.RB(v) for v in vals]
        es = s.epochs.EpochStore(corpus, clock=lambda: 5.0)
        s.struct.LEDGER.watch("corpus", corpus)
        rec = s.maintain.run_pass(es, force=True)
        out[s.label] = (_mask(rec), [b.serialize() for b in corpus],
                        [b.to_array().tolist() for b in corpus])
        monkeypatch.setattr(cont.BitmapContainer, "run_optimize", real)
    assert out["port"] == out["jax"]
    assert out["port"][0]["anomalies"] > 0
    assert out["port"][2] == [v.tolist() for v in vals]


def test_structure_and_epochs_surfaces_match_the_jax_package():
    vals = _drifted_values(seed=4)

    def counts(side):
        ep, st = side["epochs"], side["structure"]
        return (ep["flips"], ep["ingest"], {k: v["count"] for k, v in ep["freshness"].items()},
                {k: v["count"] for k, v in ep["flip_stages"].items()}, st["passes"],
                st["reclaimed_bytes"] or 0, st["rewritten_keys"] or 0,
                (st["pass_wall"] or {"count": 0})["count"])

    def moved(before, after):
        out = []
        for b, a in zip(before, after):
            if isinstance(a, dict):
                out.append({k: a[k] - b.get(k, 0) for k in a if a[k] != b.get(k, 0)})
            else:
                out.append(a - b)
        return out

    blocks, stores = {}, {}
    for s in BOTH:  # the registry is process-wide: compare what this test moved
        t = _declare(s, "ep-surface")
        corpus = [s.RB(v) for v in vals]
        es = stores[s.label] = s.epochs.EpochStore(corpus)
        s.struct.LEDGER.watch("corpus", corpus)
        before = counts(s.export.sidecar_snapshot())
        es.submit(t, {0: np.array([5])})
        es.flip()
        s.maintain.run_pass(es, force=True)
        side = s.export.sidecar_snapshot()
        ep, st = side["epochs"], side["structure"]
        gauges = {k: st[k] for k in ("containers", "bytes", "drift_ratio", "fragmentation_p99",
                                     "accretion_depth")}
        blocks[s.label] = (ep["epoch"], ep["mutlog_depth"], gauges,
                           moved(before, counts(side)))
    assert blocks["port"] == blocks["jax"]
    assert blocks["port"][3][4] == {"compacted": 1}
    ins = tinsights.epochs()
    assert ins["store_live"]["epoch"] == 2 and ins["lineage"][-1]["epoch"] == 2
    from roaringbitmap_tpu import insights as jinsights

    assert set(ins) == set(jinsights.epochs())
    assert set(tinsights.structure()) == set(jinsights.structure())
    assert tinsights.structure()["last_pass"]["outcome"] == "compacted"


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_flip_against_in_flight_lane_work_on_the_card(monkeypatch):
    """Readers pinned to epoch N stage and reduce through the overlap lane
    on the card while a flip to N+1 waits on them; each reader's result
    equals the serial oracle of its own epoch, computed on CPU tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flip patches resident rows on the card")
    vals = _values(12, seed=31, card=5000)
    cpu_corpus = [TRB(v) for v in vals]
    t = _declare(PORT)
    rng = np.random.default_rng(2)
    batches = [{int(i): _in_keys(vals[int(i)], rng, 50) for i in rng.choice(12, 3, replace=False)}
               for _ in range(4)]
    exprs = lambda c: [tq.Q.or_(*c[:6]) & tq.Q.or_(*c[6:]), tq.Q.or_(*c), tq.Q.threshold(2, *c)]
    oracle = []
    for b in [None] + batches:
        if b is not None:
            tingest.apply_batches(cpu_corpus, [tingest.MutationBatch(t, b)])
        oracle.append([tq.execute(e, cache=None).serialize() for e in exprs(cpu_corpus)])
    monkeypatch.setattr(aggregation.config, "device", "cuda")
    overlap.LANE.configure("on")
    corpus = [TRB(v) for v in vals]
    es = tepochs.EpochStore(corpus)
    es.register_working_set(list(range(len(corpus))))  # each flip patches its rows in place
    store.PACK_CACHE.close()
    store.packed_for(corpus)
    got = []
    try:
        for b in batches + [None]:
            with es.reader() as pin:
                if b is not None:
                    es.submit(t, b)
                    th = threading.Thread(target=es.flip, daemon=True)
                    th.start()
                res = tq.execute_pipelined(exprs(corpus))
                got.append((pin.epoch, [r.serialize() for r in res]))
            if b is not None:
                th.join(60.0)
    finally:
        overlap.LANE.drain()
        overlap.LANE.configure("auto")
        store.PACK_CACHE.close()
    for epoch, res in got:
        assert res == oracle[epoch]
    assert [e for e, _ in got] == list(range(len(batches) + 1))
    assert all(r["delta"]["full_repacks"] == 0 for r in es.lineage())
    assert sum(r["delta"]["delta_rows"] for r in es.lineage()) > 0


# cycles of torch.cuda._sleep that keep a side stream busy for about half a
# second: far longer than the flip's host work over a dozen bitmaps
IN_FLIGHT_SLEEP_CYCLES = 1_000_000_000


@pytest.mark.cuda
@pytest.mark.parametrize("stubbed", ["none", "synchronize", "write_order", "both"])
def test_flip_orders_its_patch_after_reads_still_in_flight(monkeypatch, stubbed):
    """A reader pinned to epoch 0 queues a copy of the resident flat rows on
    a side stream behind a long device sleep, and releases its pin with the
    copy still in flight; the flip to epoch 1 then patches those rows in
    place. Two mechanisms order the patch after the copy: the drain's
    device synchronize (``_quiesce_device``) and the delta's wait on every
    stream that read the rows (``PackedGroups._write_order``). With either
    one stubbed to a no-op the copy holds epoch 0's rows; with both stubbed
    it holds the patched rows, which shows that the check can fail."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flip patches resident rows on the card")
    if stubbed in ("synchronize", "both"):
        monkeypatch.setattr(tepochs, "_quiesce_device", lambda: None)
    if stubbed in ("write_order", "both"):
        monkeypatch.setattr(store.PackedGroups, "_write_order", lambda self, d: None)
    monkeypatch.setattr(aggregation.config, "device", "cuda")
    vals = _values(12, seed=37, card=5000)
    t = _declare(PORT)
    corpus = [TRB(v) for v in vals]
    es = tepochs.EpochStore(corpus)
    es.register_working_set(list(range(len(corpus))))
    store.PACK_CACHE.close()
    try:
        pg = store.packed_for(corpus, device="cuda")
        before = pg.device_words.clone()
        torch.cuda.synchronize()
        es.submit(t, {0: _in_keys(vals[0], np.random.default_rng(5), 64)})
        side = torch.cuda.Stream()
        with es.reader() as pin:
            with torch.cuda.stream(side):
                torch.cuda._sleep(IN_FLIGHT_SLEEP_CYCLES)
                seen = pg.device_words.clone()
            assert pin.epoch == 0
        rec = es.flip()
        torch.cuda.synchronize()
        after = pg.device_words.clone()
        assert store.packed_for(corpus, device="cuda") is pg
    finally:
        store.PACK_CACHE.close()
    assert rec["outcome"] == "flipped" and rec["delta"]["full_repacks"] == 0
    assert rec["delta"]["delta_rows"] > 0 and not torch.equal(before, after)
    if stubbed == "both":
        assert torch.equal(seen, after)
    else:
        assert torch.equal(seen, before)
