"""The port's durable tier against the JAX package.

The frozen corpus artifact (the same corpus gives byte-identical
``corpus.rbd`` in both packages, from heap, pre-serialized and mapped
sources), structural validation, atomic persists (manifest and lineage
equal with their wall-clock ``ts`` fields masked, idempotent re-persist,
garbage collection), each of the five ``durable.persist`` crash points,
recovery across the two packages in both directions, a torn artifact
skipped, the priced persist verdict and the flip hook, the readmit that
teaches the residency authority's ``readmit_s`` curve, the mapped
demotion rung with its decision, and ``close`` after a readmit — each
held against the JAX package on the same seeded numpy inputs. Batch ids
restart at 1 in both packages around every test. The port's device path
runs on CPU tensors (``aggregation.config.device = "cpu"``).
"""

import itertools
import json
import os
import time

import numpy as np
import pytest

from roaringbitmap_tpu import durable as jd
from roaringbitmap_tpu.cost import epoch as jepoch_cost
from roaringbitmap_tpu.cost import residency as jres_cost
from roaringbitmap_tpu.models.roaring import RoaringBitmap as JRB
from roaringbitmap_tpu.observe import decisions as jdec
from roaringbitmap_tpu.observe import export as jexport
from roaringbitmap_tpu.observe import outcomes as jout
from roaringbitmap_tpu.parallel import store as jstore
from roaringbitmap_tpu.robust import faults as jfaults
from roaringbitmap_tpu.robust import ladder as jladder
from roaringbitmap_tpu.robust.errors import TransientDeviceError as JTransient
from roaringbitmap_tpu.durable import recovery as jrecovery
from roaringbitmap_tpu.durable import store as jdstore
from roaringbitmap_tpu.serve import epochs as jepochs
from roaringbitmap_tpu.serve import ingest as jingest
from roaringbitmap_tpu.serve import slo as jslo

from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch import durable as td
from roaringbitmap_tpu_torch import insights as tinsights
from roaringbitmap_tpu_torch.cost import epoch as tepoch_cost
from roaringbitmap_tpu_torch.cost import residency as tres_cost
from roaringbitmap_tpu_torch.durable import recovery as trecovery
from roaringbitmap_tpu_torch.durable import store as tdstore
from roaringbitmap_tpu_torch.observe import decisions as tdec
from roaringbitmap_tpu_torch.observe import export as texport
from roaringbitmap_tpu_torch.observe import outcomes as tout
from roaringbitmap_tpu_torch.parallel import aggregation, store
from roaringbitmap_tpu_torch.robust import faults as tfaults
from roaringbitmap_tpu_torch.robust import ladder as tladder
from roaringbitmap_tpu_torch.robust.errors import TransientDeviceError as TTransient
from roaringbitmap_tpu_torch.serve import epochs as tepochs
from roaringbitmap_tpu_torch.serve import ingest as tingest
from roaringbitmap_tpu_torch.serve import slo as tslo


class Side:
    def __init__(self, label, RB, d, dstore, recovery, epochs, ingest, slo, pstore, faults,
                 transient, dec, out, export, epoch_cost, res_cost):
        self.label, self.RB, self.d, self.dstore, self.recovery = label, RB, d, dstore, recovery
        self.epochs, self.ingest, self.slo, self.pstore = epochs, ingest, slo, pstore
        self.faults, self.transient, self.dec, self.out = faults, transient, dec, out
        self.export, self.epoch_cost, self.res_cost = export, epoch_cost, res_cost

    def packed(self, bitmaps, cache=None):
        c = cache if cache is not None else self.pstore.PACK_CACHE
        if self.label == "port":
            return c.get_packed(bitmaps, device="cpu")
        return c.get_packed(bitmaps)


PORT = Side("port", TRB, td, tdstore, trecovery, tepochs, tingest, tslo, store, tfaults,
            TTransient, tdec, tout, texport, tepoch_cost, tres_cost)
JAX = Side("jax", JRB, jd, jdstore, jrecovery, jepochs, jingest, jslo, jstore, jfaults,
           JTransient, jdec, jout, jexport, jepoch_cost, jres_cost)
BOTH = (PORT, JAX)


def _reset():
    for s in BOTH:
        s.slo.reset()
        s.out.reset()
        s.dec.LOG.clear()
        s.faults.clear()
        s.epoch_cost.MODEL.reset()
        s.res_cost.MODEL.reset()
        s.pstore.set_demotion_probe(None)
        s.pstore.PACK_CACHE.close()
    tladder.LADDER.reset()
    jladder.LADDER.reset()


@pytest.fixture(autouse=True)
def durable_state(monkeypatch):
    monkeypatch.setattr(aggregation.config, "device", "cpu")
    for s in BOTH:
        monkeypatch.setattr(s.ingest, "_BATCH_IDS", itertools.count(1))
    _reset()
    yield
    _reset()


def _values(n=4, seed=3, card=1200):
    rng = np.random.default_rng(seed)
    vals = [np.sort(rng.choice(1 << 18, card, replace=False)).astype(np.uint32) for _ in range(n)]
    # a run-heavy and a bitmap-heavy member, so every container kind lands
    vals.append(np.arange(5 << 16, (5 << 16) + 70000, dtype=np.uint32))
    vals.append(np.sort(rng.choice(1 << 16, 9000, replace=False)).astype(np.uint32))
    return vals


def _store(s, vals, tenant="t-dur"):
    s.slo.TENANTS.declare(tenant, quota_qps=1e6, burst=1e6)
    return s.epochs.EpochStore([s.RB(v) for v in vals], clock=lambda: 77.0)


def _flip_once(es, tenant="t-dur", idx=0, values=(7, 11, 13)):
    es.submit(tenant, {idx: list(values)}, stamp=70.0)
    return es.flip(reason="test")


def _masked_json(path):
    doc = json.load(open(path))
    doc.pop("ts", None)
    return doc


def _tree(root):
    return sorted(os.listdir(root))


# ---------------------------------------------------------------------------
# the frozen corpus format
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_corpus_bytes_are_the_jax_bytes_from_every_source(tmp_path, seed):
    vals = _values(seed=seed)
    arts = {}
    for s in BOTH:
        bms = [s.RB(v) for v in vals]
        bms[1].run_optimize()
        path = str(tmp_path / f"{s.label}.rbd")
        stats = s.d.write_corpus(path, [bms[0], bms[1].serialize()] + bms[2:])
        mc = s.d.MappedCorpus(path)
        again = str(tmp_path / f"{s.label}-again.rbd")
        s.d.write_corpus(again, mc.bitmaps())  # a mapped bitmap re-persists as its slice
        arts[s.label] = (stats, open(path, "rb").read(), open(again, "rb").read(),
                         [bytes(mc.payload(i)) for i in range(len(mc))],
                         [mc.bitmap(i).to_mutable().serialize() for i in range(len(mc))])
        mc.close()
    assert arts["port"] == arts["jax"]
    stats, raw, again, payloads, back = arts["port"]
    assert raw == again and stats["artifact_bytes"] == len(raw)
    want = [TRB(v) for v in vals]
    want[1].run_optimize()
    assert payloads == [b.serialize() for b in want] == back


def test_corpus_structural_corruption_is_refused_in_both_packages(tmp_path):
    path = str(tmp_path / "c.rbd")
    jd.write_corpus(path, [JRB(v) for v in _values(2)])
    raw = open(path, "rb").read()
    cases = {
        "magic": b"XXXX" + raw[4:],
        "version": raw[:4] + (9).to_bytes(2, "little") + raw[6:],
        "truncated": raw[:10],
        "directory": raw[:40],
    }
    for name, bad in cases.items():
        p = str(tmp_path / f"{name}.rbd")
        open(p, "wb").write(bad)
        for s, exc in ((PORT, td.format.InvalidRoaringFormat), (JAX, jd.format.InvalidRoaringFormat)):
            with pytest.raises(exc):
                s.d.MappedCorpus(p)


# ---------------------------------------------------------------------------
# atomic persists
# ---------------------------------------------------------------------------


def test_persist_writes_the_jax_artifact_and_is_idempotent(tmp_path):
    vals = _values(seed=5)
    out = {}
    for s in BOTH:
        es = _store(s, vals)
        ds = s.d.DurableStore(str(tmp_path / s.label))
        _flip_once(es)
        rec = ds.persist(es)
        again = ds.persist(es)
        d = rec["dir"]
        manifest = _masked_json(os.path.join(d, "MANIFEST.json"))
        lineage = _masked_json(os.path.join(d, "lineage.json"))
        for r in lineage["lineage"]:
            r.pop("wall_s")
        # artifact_bytes counts the two JSON files, whose wall-clock ts
        # fields print to different lengths: the corpus file's own size is
        # compared through the manifest instead
        out[s.label] = (
            {k: v for k, v in rec.items() if k not in ("dir", "wall_s", "artifact_bytes")},
            {k: v for k, v in again.items() if k != "dir"},
            open(os.path.join(d, "corpus.rbd"), "rb").read(),
            lineage, {k: v for k, v in manifest.items() if k != "files"},
            manifest["files"]["corpus.rbd"], _tree(ds.root), ds.pending_epochs(es),
        )
    assert out["port"] == out["jax"]
    assert out["port"][1]["fresh"] is False and out["port"][7] == 0


@pytest.mark.parametrize("crash_point", [1, 2, 3, 4, 5])
def test_each_crash_point_leaves_what_the_jax_package_leaves(tmp_path, crash_point):
    """A transient fault at crash point ``crash_point`` of the second
    persist: points 1-4 precede the rename, so ``recover`` finds the
    previous complete epoch (1); point 5 follows it, so the persist
    reports aborted but the new epoch (2) is published and recovers."""
    vals = _values(seed=6)
    out = {}
    for s in BOTH:
        es = _store(s, vals)
        root = str(tmp_path / s.label)
        ds = s.d.DurableStore(root, keep=3)
        _flip_once(es, values=(1,))
        ds.persist(es)
        _flip_once(es, values=(2,))
        with s.faults.inject("durable.persist", s.transient, after=crash_point - 1):
            rec = ds.persist(es)
        tree = _tree(root)
        rc = s.d.recover(root)
        got = (rc.epoch, [rc.bitmap(i).serialize() for i in range(len(rc.corpus))])
        rc.close()
        nxt = ds.persist(es)
        out[s.label] = (rec, tree, got, nxt["outcome"], _tree(root), ds.pending_epochs(es))
    assert out["port"] == out["jax"]
    rec, tree, (epoch, _bytes), nxt, after, pending = out["port"]
    assert rec["outcome"] == "aborted"
    assert epoch == (2 if crash_point == 5 else 1)
    # after point 5 the epoch is on disk, but the aborted persist never
    # recorded it: the re-persist finds the directory and counts it pending
    assert nxt == "persisted" and pending == (1 if crash_point == 5 else 0)
    assert not [d for d in after if d.startswith(".tmp-")]


def test_a_fatal_persist_fault_raises_in_both_packages(tmp_path):
    for s in BOTH:
        es = _store(s, _values(2))
        ds = s.d.DurableStore(str(tmp_path / s.label))
        _flip_once(es)
        with s.faults.inject("durable.persist", ValueError, after=0):
            with pytest.raises(ValueError):
                ds.persist(es)


def test_priced_verdicts_flip_hook_and_gc_match_the_jax_package(tmp_path):
    vals = _values(2, seed=8)
    out = {}
    for s in BOTH:
        es = _store(s, vals)
        ds = s.d.DurableStore(str(tmp_path / s.label / "a"), keep=2)
        _flip_once(es)
        first = ds.maybe_persist(es)
        noop = ds.maybe_persist(es)
        joined = [e["engine"] for e in s.out.tail() if e["site"] == "durable.persist"]
        es2 = _store(s, vals, tenant="t-skip")
        ds2 = s.d.DurableStore(str(tmp_path / s.label / "b"))
        _flip_once(es2, tenant="t-skip")
        old = s.epoch_cost.MODEL.coeffs["persist_overhead_us"]
        s.epoch_cost.MODEL.coeffs["persist_overhead_us"] = 1e12
        try:
            skipped = ds2.maybe_persist(es2)
        finally:
            s.epoch_cost.MODEL.coeffs["persist_overhead_us"] = old
        es.attach_durable(ds)
        hooked = [_flip_once(es, values=(100 + i,))["durable"] for i in range(3)]
        decided = [(d["decision"], {k: v for k, v in d["inputs"].items()
                                    if k not in ("est_us", "artifact_kb")})
                   for d in s.dec.decisions() if d["site"] == "durable.persist"]
        out[s.label] = (
            {k: v for k, v in first.items() if k not in ("dir", "wall_s", "artifact_bytes")},
            noop, joined, skipped,
            hooked, _tree(ds.root), ds.stats()["persisted_epoch"], decided,
        )
    assert out["port"] == out["jax"]
    assert out["port"][0]["outcome"] == "persisted" and out["port"][3]["outcome"] == "skipped"
    assert out["port"][5] == ["epoch_00000003", "epoch_00000004"]


# ---------------------------------------------------------------------------
# recovery
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)])
def test_an_artifact_recovers_in_the_other_package(tmp_path, writer, reader):
    vals = _values(seed=9)
    es = _store(writer, vals)
    ds = writer.d.DurableStore(str(tmp_path), keep=3)
    _flip_once(es, values=(1, 2))
    ds.persist(es)
    _flip_once(es, values=(3, 4))
    ds.persist(es)
    rc = reader.d.recover(str(tmp_path))
    assert isinstance(rc, reader.d.Recovery) and rc.epoch == 2
    assert [rc.bitmap(i).serialize() for i in range(len(rc.corpus))] == \
        [b.serialize() for b in es.corpus]
    assert [r["epoch"] for r in rc.lineage] == [1, 2]
    assert reader.recovery.LAST["epoch"] == 2 and reader.recovery.LAST["torn_skipped"] == 0
    _store(reader, vals, tenant="t-resume")
    resumed = rc.resume_store()
    assert resumed.current() == 2 and [r["epoch"] for r in resumed.lineage()] == [1, 2]
    resumed.submit("t-resume", {0: [99]})
    assert resumed.flip(reason="post-resume")["epoch"] == 3
    assert resumed.corpus[0].contains(99) and not rc.bitmap(0).contains(99)
    rc.close()


@pytest.mark.parametrize("damage", ["truncate", "flip-byte", "no-manifest"])
def test_a_torn_artifact_is_skipped_in_both_packages(tmp_path, damage):
    vals = _values(2, seed=10)
    out = {}
    for s in BOTH:
        root = str(tmp_path / s.label)
        es = _store(s, vals)
        ds = s.d.DurableStore(root, keep=3)
        _flip_once(es, values=(1,))
        ds.persist(es)
        _flip_once(es, values=(2,))
        ds.persist(es)
        newest = os.path.join(root, s.dstore.epoch_dir_name(2))
        corpus = os.path.join(newest, "corpus.rbd")
        raw = open(corpus, "rb").read()
        if damage == "truncate":
            open(corpus, "wb").write(raw[: len(raw) // 2])
        elif damage == "flip-byte":
            open(corpus, "wb").write(raw[:-1] + bytes([raw[-1] ^ 0xFF]))
        else:
            os.remove(os.path.join(newest, "MANIFEST.json"))
        torn = s.export.sidecar_snapshot()["durable"]["recoveries"].get("torn", 0)
        rc = s.d.recover(root)
        got = (rc.epoch, s.recovery.LAST["torn_skipped"],
               s.export.sidecar_snapshot()["durable"]["recoveries"].get("torn", 0) - torn,
               [rc.bitmap(i).serialize() for i in range(len(rc.corpus))])
        rc.close()
        out[s.label] = got
    assert out["port"] == out["jax"]
    assert out["port"][:3] == (1, 1, 1)


def test_an_empty_root_recovers_nothing_in_both_packages(tmp_path):
    for s in BOTH:
        assert s.d.recover(str(tmp_path / s.label)) is None
        assert s.recovery.LAST["epoch"] is None


def test_readmit_teaches_readmit_s_and_close_follows_the_jax_package(tmp_path):
    """The readmit packs the mapped working set, records a priced
    ``durable.readmit`` decision, and its join teaches ``readmit_s``; the
    warm pack is then a hit. While the pack cache still holds views into
    the map, ``close`` raises ``BufferError`` in both packages; once the
    cache is closed, ``close`` succeeds."""
    vals = _values(seed=11)
    out = {}
    for s in BOTH:
        root = str(tmp_path / s.label)
        es = _store(s, vals)
        ds = s.d.DurableStore(root)
        _flip_once(es)
        ds.persist(es)
        rc = s.d.recover(root)
        assert s.res_cost.MODEL.readmit_estimate("agg") is None
        rep = rc.readmit()
        est = s.res_cost.MODEL.readmit_estimate("agg")
        before = s.pstore.PACK_CACHE.stats()["hits"]
        s.packed(rc.corpus.bitmaps())
        hit = s.pstore.PACK_CACHE.stats()["hits"] - before
        decided = [(d["decision"], d["inputs"]) for d in s.dec.decisions()
                   if d["site"] == "durable.readmit"]
        with pytest.raises(BufferError):
            rc.close()
        s.pstore.PACK_CACHE.close()
        rc.close()
        rc2 = s.d.recover(root)
        rep2 = rc2.readmit()
        decided2 = [d["inputs"] for d in s.dec.decisions() if d["site"] == "durable.readmit"][-1]
        s.pstore.PACK_CACHE.close()
        rc2.close()
        out[s.label] = (rep["working_sets"], est is not None and est > 0, hit, decided,
                        rep2["working_sets"], sorted(decided2), sorted(decided2.get("est_us", {})))
    assert out["port"] == out["jax"]
    assert out["port"][1] is True and out["port"][2] == 1 and out["port"][6] == ["readmit"]


# ---------------------------------------------------------------------------
# the mapped rung
# ---------------------------------------------------------------------------


def _evictions(s, probe, readmit_s=None):
    rng = np.random.default_rng(17)
    sets = [[s.RB(np.sort(rng.choice(1 << 18, 1500, replace=False)).astype(np.uint32))
             for _ in range(2)] for _ in range(3)]
    s.pstore.set_demotion_probe(probe)
    if readmit_s is not None:
        s.res_cost.MODEL.readmit_s["agg"] = readmit_s
    cache = s.pstore.PackCache(max_bytes=1 << 60)
    for ws in sets:
        s.packed(ws, cache)
    seq0 = s.dec.decisions()[-1]["seq"] if s.dec.decisions() else 0
    demote = s.export.sidecar_snapshot()["durable"]["demotions"]
    cache.configure(max_bytes=1)
    after = s.export.sidecar_snapshot()["durable"]["demotions"]
    rows = [(d["decision"], {k: v for k, v in d["inputs"].items() if k not in ("bytes",)})
            for d in s.dec.decisions() if d["site"] == "pack_cache.evict" and d["seq"] > seq0]
    cache.close()
    return rows, {k: after[k] - demote.get(k, 0) for k in after if after[k] != demote.get(k, 0)}


@pytest.mark.parametrize("case", ["no-probe", "mapped", "mapped-priced", "probe-false", "probe-raises"])
def test_eviction_rungs_and_decisions_match_the_jax_package(case):
    def raises(kind):
        raise RuntimeError("broken probe")

    probe = {"no-probe": None, "mapped": lambda k: True, "mapped-priced": lambda k: True,
             "probe-false": lambda k: False, "probe-raises": raises}[case]
    readmit = 0.0025 if case == "mapped-priced" else None
    got = _evictions(PORT, probe, readmit)
    want = _evictions(JAX, probe, readmit)
    assert got == want
    rows, moved = got
    rung = "mapped" if case.startswith("mapped") else "discard"
    assert moved == {rung: 2} and len(rows) == 2
    assert all(r[0] == ("demote-mapped" if rung == "mapped" else "lru") for r in rows)
    assert all(r[1]["rung"] == rung for r in rows)
    if case == "mapped-priced":
        assert all(r[1]["est_us"] == {"readmit": 2500.0} for r in rows)


def test_persist_installs_the_demotion_probe_in_both_packages(tmp_path):
    for s in BOTH:
        assert s.pstore._DEMOTE_PROBE is None
        es = _store(s, _values(2))
        ds = s.d.DurableStore(str(tmp_path / s.label))
        _flip_once(es)
        ds.persist(es)
        assert s.pstore._DEMOTE_PROBE is not None and s.pstore._DEMOTE_PROBE("agg") is True


def test_durable_surfaces_match_the_jax_package(tmp_path, monkeypatch):
    vals = _values(2, seed=12)
    out, keep = {}, []
    for s in BOTH:
        es = _store(s, vals, tenant="t-side")
        ds = s.d.DurableStore(str(tmp_path / s.label))
        keep.append(ds)
        # one clock for both: the manifest's `ts` and the lineage's flip
        # walls, and so the artifact bytes, are then the same in both packages
        with monkeypatch.context() as m:
            m.setattr(time, "time", lambda: 1_700_000_000.125)
            m.setattr(time, "perf_counter", lambda: 5.0)
            _flip_once(es, tenant="t-side")
            ds.persist(es)
        blk = s.export.sidecar_snapshot()["durable"]
        out[s.label] = (blk["epoch"], blk["serving_epoch"], blk["pending_epochs"],
                        blk["artifact_bytes"], sorted(blk["persist_stages"]), sorted(blk))
    assert out["port"] == out["jax"]
    from roaringbitmap_tpu import insights as jinsights

    assert set(tinsights.durable()) == set(jinsights.durable())
    assert tinsights.durable()["store_live"]["persisted_epoch"] == 1
    assert td.PERSIST_STAGES == jd.PERSIST_STAGES and td.SCHEMA == jd.SCHEMA
    assert td.PERSIST_OUTCOMES == jd.PERSIST_OUTCOMES and td.DEFAULT_KEEP == jd.DEFAULT_KEEP
    assert td.current_store() is keep[0]


def test_persist_counts_its_serialized_bytes(tmp_path):
    """Every heap bitmap a persist serializes counts in
    ``rb_tpu_serial_bytes_total{direction="serialize"}``, the same bytes in
    both packages."""
    vals = _values(seed=13)
    moved = {}
    for s in BOTH:
        es = _store(s, vals)
        ds = s.d.DurableStore(str(tmp_path / s.label))
        before = s.export.sidecar_snapshot()["serial_bytes"].get("serialize", 0)
        ds.persist(es)
        moved[s.label] = s.export.sidecar_snapshot()["serial_bytes"]["serialize"] - before
    assert moved["port"] == moved["jax"] == sum(len(TRB(v).serialize()) for v in vals)
