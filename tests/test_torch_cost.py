"""The port's cost facade against the JAX package.

Both packages' eight pricing authorities refit from the same seeded
sample lists (every site the authorities read, with poisoned samples
among them) and from the same decision–outcome ledger traffic, and must
give equal reports, curves, provenance, drift and state; the facade's
names, ``calibration_state()``, ``refit_all``, the ``RB_TPU_COST_STATE``
round trip and a state the JAX package saved must be equal too. Then the
port's departures: the backend stamp (the device type of the device
tier, refused across devices) and the breakeven gate, pushed into the
dispatcher only where the device tier is a card. The residency refit
consumes ledger samples at most once. Both packages run on the CPU
(``aggregation.config.device = "cpu"``); no clock is compared.
"""

import json

import numpy as np
import pytest

from roaringbitmap_tpu import cost as jcost
from roaringbitmap_tpu.columnar import costmodel as jcolcost
from roaringbitmap_tpu.observe import decisions as jdec
from roaringbitmap_tpu.observe import outcomes as jout
from roaringbitmap_tpu.parallel import aggregation as jagg
from roaringbitmap_tpu.parallel import store as jstore

from roaringbitmap_tpu_torch import cost as tcost
from roaringbitmap_tpu_torch.columnar import costmodel as tcolcost
from roaringbitmap_tpu_torch.cost import breakeven as tbreakeven
from roaringbitmap_tpu_torch.cost import residency as tresidency
from roaringbitmap_tpu_torch.observe import decisions as tdec
from roaringbitmap_tpu_torch.observe import outcomes as tout
from roaringbitmap_tpu_torch.parallel import aggregation as tagg
from roaringbitmap_tpu_torch.parallel import store as tstore

NAMES = [
    "columnar-cutoff", "compaction", "device-breakeven", "epoch-flip",
    "fusion-batch", "pack-residency", "planner-cardinality", "serve-admission",
]
# the breakeven curves view reads each package's own dispatcher gate:
# the port pushes the gate only on a card (the departure tested below)
GATE_KEY = "config_min_device_containers"


def _reset_both():
    for cost_mod, dec, out in ((tcost, tdec, tout), (jcost, jdec, jout)):
        cost_mod.reset_all()
        out.reset()
        dec.LOG.clear()


@pytest.fixture(autouse=True)
def both_on_cpu(monkeypatch):
    """Both packages on the CPU with equal pack-cache budgets, every
    authority at its default, both ledgers empty; the dispatcher gates
    restored after each test (the JAX package's refit pushes its gate)."""
    monkeypatch.setattr(tagg.config, "device", "cpu")
    monkeypatch.setattr(tagg.config, "min_device_containers", 64)
    monkeypatch.setattr(jagg.config, "min_device_containers", 64)
    monkeypatch.setattr(tstore.PACK_CACHE, "max_bytes", jstore.PACK_CACHE.max_bytes)
    monkeypatch.delenv("RB_TPU_COLUMNAR_CAL", raising=False)
    monkeypatch.delenv("RB_TPU_COST_STATE", raising=False)
    _reset_both()
    yield
    _reset_both()


def _columnar_table(backend="cpu"):
    """A calibrated columnar table (both packages' schema) to refit from."""
    coeffs = {
        group: {
            eng: {shape: [10.0 * (i + 1) + 3 * j, 0.5 + 0.1 * i + 0.05 * j]
                  for j, shape in enumerate(("array", "bitmap", "run"))}
            for i, eng in enumerate(("per-container", "columnar-cpu", "columnar-device"))
        }
        for group in ("and", "or")
    }
    return {"schema": tcolcost.SCHEMA, "backend": backend, "calibrated": True,
            "coeffs": coeffs, "ship_us_per_row": 0.25, "fold_rows_min": None,
            "provenance": "calibrated"}


def _samples(seed=5, with_device=True):
    """One seeded list of joined samples for every site the eight
    authorities read, with poisoned entries among them."""
    rng = np.random.default_rng(seed)
    out = []
    tiers = {"per-container": (40.0, 0.9), "columnar-cpu": (60.0, 0.5)}
    if with_device:
        tiers["device"] = (900.0, 0.02)
    for tier, (oh, slope) in tiers.items():
        for rows in (32, 128, 512, 2048, 64, 1024, 4096, 256):
            us = (oh + rows * slope) * float(rng.uniform(0.9, 1.1))
            out.append({"site": "agg.dispatch", "engine": tier, "inputs": {"rows": rows},
                        "measured_s": us / 1e6})
    out.append({"site": "agg.dispatch", "engine": "device", "inputs": {"rows": 64},
                "measured_s": 50.0})  # 20x off its median: rejected
    out.append({"site": "agg.dispatch", "engine": "device", "inputs": {}, "measured_s": 0.1})
    for i in range(6):
        out.append({"site": "pack_cache.evict", "engine": "lru", "seq": 10 + i,
                    "inputs": {"kind": ("agg", "threshold")[i % 2]},
                    "measured_s": float(rng.uniform(0.2, 1.4))})
    out.append({"site": "pack_cache.evict", "engine": "lru", "seq": 30, "inputs": {},
                "measured_s": 0.5})
    out.append({"site": "durable.readmit", "engine": "readmit", "seq": 31,
                "inputs": {"kind": "agg"}, "measured_s": 0.05})
    for site, engines in (("fusion.batch", ("fused", "per-query")), ("fusion.hedge", ("solo", "window")),
                          ("serve.admit", ("admit", "queue")), ("epoch.flip", ("flip",)),
                          ("durable.persist", ("persist",)), ("serve.maintain", ("compact",))):
        for i in range(8):
            eng = engines[i % len(engines)]
            out.append({"site": site, "engine": eng, "predicted_us": float(rng.uniform(50, 3000)),
                        "measured_s": float(rng.uniform(1e-5, 5e-3))})
        out.append({"site": site, "engine": engines[0], "predicted_us": "bad", "measured_s": 1e-3})
        out.append({"site": site, "engine": engines[0], "predicted_us": 1.0, "measured_s": 1e9})
    for op in ("and", "or", "threshold"):
        for _ in range(5):
            out.append({"site": "query.plan", "inputs": {"op": op, "est_card": float(rng.uniform(100, 5000))},
                        "actual": float(rng.uniform(50, 9000))})
    for group, op in (("and", "and"), ("or", "xor")):
        for eng in ("per-container", "columnar-cpu"):
            for n in (16, 64, 256, 1024, 32):
                out.append({"site": "columnar.cutoff", "engine": eng, "shape": "bitmap", "n": n,
                            "op": op, "measured_us": (20.0 + 0.7 * n) * float(rng.uniform(0.8, 1.2))})
    return out


def _calibrate_both():
    # a table each: from_dict adopts the dict itself, which the refit edits
    assert tcolcost.MODEL.from_dict(_columnar_table())
    assert jcolcost.MODEL.from_dict(_columnar_table())


def _view(state: dict) -> dict:
    """``calibration_state()`` with the breakeven view's own-gate key
    dropped (compared separately)."""
    state = json.loads(json.dumps(state))
    state["authorities"]["device-breakeven"]["curves"].pop(GATE_KEY)
    return state


# ---------------------------------------------------------------------------
# names, the protocol, refits from explicit sample lists
# ---------------------------------------------------------------------------


def test_names_schema_and_default_calibration_state_match():
    assert tcost.names() == jcost.names() == NAMES
    assert set(tcost.AUTHORITIES) == set(jcost.AUTHORITIES)
    assert tcost.STATE_SCHEMA == jcost.STATE_SCHEMA
    assert tcost.calibration_state() == jcost.calibration_state()
    assert tcost.provenances() == jcost.provenances()
    assert tcost.drift_summary() == jcost.drift_summary() == {}
    with pytest.raises(KeyError, match="unknown pricing authority"):
        tcost.authority("nope")
    # an empty ledger refits nothing, never an error
    assert tcost.refit_all() == jcost.refit_all()


@pytest.mark.parametrize("with_device", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_each_authority_refits_like_the_jax_package(name, with_device):
    _calibrate_both()
    samples = _samples(with_device=with_device)
    t, j = tcost.authority(name), jcost.authority(name)
    got, want = t.refit_from_outcomes(samples=samples), j.refit_from_outcomes(samples=samples)
    assert got == want
    if name != "columnar-cutoff":
        assert got["moved"], f"{name} moved nothing on its samples"
    tc, jc = t.curves(), j.curves()
    if name == "device-breakeven":
        # the departure: the JAX package pushes a measured gate into its
        # dispatcher on any backend; the port only where the device is a card
        assert tc.pop(GATE_KEY) == 64
        assert jc.pop(GATE_KEY) == (jc["gate_rows"] or 64)
        assert (jc["gate_rows"] is not None) == with_device
    assert tc == jc
    assert t.provenance() == j.provenance()
    assert t.state() == j.state()
    # a second refit over the same explicit list: equal again (residency
    # skips serials it folded; the others refit the same way)
    assert t.refit_from_outcomes(samples=samples) == j.refit_from_outcomes(samples=samples)
    assert t.state() == j.state()


def test_refit_all_over_one_list_and_the_state_round_trip(tmp_path, monkeypatch):
    _calibrate_both()
    samples = _samples(seed=9, with_device=False)
    assert tcost.refit_all(samples) == jcost.refit_all(samples)
    assert tcost.calibration_state() == jcost.calibration_state()
    assert tcost.provenances() == jcost.provenances()
    before = tcost.calibration_state()
    path = tmp_path / "cost.json"
    monkeypatch.setenv("RB_TPU_COST_STATE", str(path))
    assert tcost.save_state() == str(path)
    doc = json.loads(path.read_text())
    assert doc["schema"] == tcost.STATE_SCHEMA and sorted(doc["authorities"]) == NAMES
    tcost.reset_all()
    assert tcost.calibration_state() != before
    assert tcost.load_state() == {name: True for name in NAMES}
    assert tcost.calibration_state() == before
    # corrupt or foreign files: all False, the state untouched
    path.write_text("{not json")
    assert tcost.load_state() == {name: False for name in NAMES}
    path.write_text(json.dumps({"schema": "other/1", "authorities": {}}))
    assert tcost.load_state() == {name: False for name in NAMES}
    assert tcost.calibration_state() == before
    monkeypatch.delenv("RB_TPU_COST_STATE")
    assert tcost.save_state() is None
    assert tcost.load_state() == {name: False for name in NAMES}


def test_a_state_the_jax_package_saved_loads_with_an_equal_calibration_state(tmp_path):
    """The JAX package on a host: calibrated columnar, CPU-tier dispatch
    curves (no device samples, so no gate), every other authority refit;
    its file loads into the port with the same calibration_state()."""
    assert jcolcost.MODEL.from_dict(_columnar_table())
    jcost.refit_all(_samples(seed=11, with_device=False))
    path = str(tmp_path / "jax_cost.json")
    assert jcost.save_state(path) == path
    assert tcost.load_state(path) == {name: True for name in NAMES}
    assert tcost.calibration_state() == jcost.calibration_state()
    assert tcost.provenances() == jcost.provenances()
    for name in NAMES:
        assert tcost.authority(name).state() == jcost.authority(name).state()


def test_drift_from_the_ledger_matches_the_jax_package():
    """The same decisions and measured joins in both ledgers: every
    authority's drift, the drift summary and the ledger-fed refit agree."""
    _calibrate_both()
    rng = np.random.default_rng(17)
    plan = []
    for tier, rows, us in (("per-container", r, 40 + 0.9 * r) for r in (32, 64, 128, 256, 512, 1024, 2048)):
        plan.append(("agg.dispatch", tier, {"op": "or", "rows": rows}, None, us * rng.uniform(0.9, 1.1)))
    for tier, rows, us in (("device", r, 900 + 0.02 * r) for r in (32, 64, 128, 256, 512, 1024, 2048)):
        plan.append(("agg.dispatch", tier, {"op": "or", "rows": rows}, None, us * rng.uniform(0.9, 1.1)))
    for site, eng in (("fusion.batch", "fused"), ("fusion.batch", "per-query"), ("fusion.hedge", "solo"),
                      ("serve.admit", "admit"), ("serve.admit", "queue"), ("epoch.flip", "flip"),
                      ("serve.maintain", "compact")):
        for _ in range(4):
            plan.append((site, eng, {}, {eng: float(rng.uniform(100, 900))}, float(rng.uniform(50, 3000))))
    for i in range(3):
        plan.append(("columnar.cutoff", "columnar-cpu",
                     {"op": "or", "shape": "run", "na": 40 + i, "nb": 50},
                     {"per-container": 900.0, "columnar-cpu": 300.0}, float(rng.uniform(50, 600))))

    def feed(dec, out):
        for site, eng, inputs, est, us in plan:
            kw = dict(inputs)
            if est is not None:
                kw["est_us"] = est
            seq = dec.record_decision(site, eng, outcome=True, **kw)
            out.resolve(seq, site, us / 1e6, engine=eng)

    feed(tdec, tout)
    feed(jdec, jout)
    # curves first (the breakeven drift judges installed curves)
    assert (tcost.authority("device-breakeven").refit_from_outcomes()
            == jcost.authority("device-breakeven").refit_from_outcomes())
    for name in NAMES:
        assert tcost.authority(name).drift() == jcost.authority(name).drift(), name
    summary = tcost.drift_summary()
    assert summary == jcost.drift_summary()
    assert {"device-breakeven", "fusion-batch", "serve-admission", "epoch-flip",
            "compaction", "columnar-cutoff"} <= set(summary)
    assert tcost.refit_all() == jcost.refit_all()
    assert _view(tcost.calibration_state()) == _view(jcost.calibration_state())


# ---------------------------------------------------------------------------
# the departures: backend stamps and the gate push
# ---------------------------------------------------------------------------


def test_backend_stamp_is_the_device_tiers_type(monkeypatch):
    assert tbreakeven._current_backend() == tresidency._current_backend() == "cpu"
    monkeypatch.setattr(tagg.config, "device", "cuda")
    assert tbreakeven._current_backend() == tresidency._current_backend() == "cuda"
    assert tbreakeven._current_backend() == tcolcost._backend()


@pytest.mark.parametrize("here,there", [("cpu", "cuda"), ("cuda", "cpu")])
def test_a_state_stamped_for_the_other_device_is_refused(here, there, monkeypatch):
    monkeypatch.setattr(tagg.config, "device", there)
    tcost.refit_all(_samples(seed=3, with_device=True))
    states = {name: tcost.authority(name).state() for name in NAMES}
    assert states["device-breakeven"]["backend"] == there
    assert states["pack-residency"]["backend"] == there
    monkeypatch.setattr(tagg.config, "device", here)
    tagg.config.min_device_containers = 64  # the "cuda" refit pushed its gate
    tcost.reset_all()
    for name in ("device-breakeven", "pack-residency"):
        assert not tcost.authority(name).load_state(states[name]), name
        assert tcost.authority(name).provenance() == "static"
    # the other authorities carry no stamp and are adopted (the columnar
    # model was never calibrated: its state is refused on either device)
    verdicts = {name: tcost.authority(name).load_state(states[name]) for name in NAMES}
    assert verdicts == {name: name not in ("device-breakeven", "pack-residency", "columnar-cutoff")
                        for name in NAMES}
    assert states["device-breakeven"]["gate_rows"] is not None
    assert tagg.config.min_device_containers == 64


def test_the_breakeven_gate_moves_the_dispatcher_only_on_a_card(monkeypatch):
    samples = _samples(seed=21, with_device=True)
    rep = tcost.authority("device-breakeven").refit_from_outcomes(samples=samples)
    gate = rep["moved"]["gate_rows"]["to"]
    assert gate != 64 and tbreakeven.GATE_MIN <= gate <= tbreakeven.GATE_MAX
    assert tagg.config.min_device_containers == 64  # device="cpu": fitted, not pushed
    state = tbreakeven.MODEL.to_dict()
    assert state["backend"] == "cpu"
    # the same traffic measured with the device tier on a card: pushed by
    # the refit and by load_state alike
    monkeypatch.setattr(tagg.config, "device", "cuda")
    tbreakeven.MODEL.reset()
    tbreakeven.MODEL.refit_from_outcomes(samples=samples)
    assert tagg.config.min_device_containers == gate
    cuda_state = tbreakeven.MODEL.to_dict()
    assert cuda_state["backend"] == "cuda"
    tagg.config.min_device_containers = 64
    tbreakeven.MODEL.reset()
    assert tbreakeven.MODEL.from_dict(cuda_state)
    assert tagg.config.min_device_containers == gate
    monkeypatch.setattr(tagg.config, "device", "cpu")
    tagg.config.min_device_containers = 64
    assert tbreakeven.MODEL.from_dict(state) and tagg.config.min_device_containers == 64


# ---------------------------------------------------------------------------
# residency: ledger samples consumed at most once
# ---------------------------------------------------------------------------


def test_residency_refit_consumes_ledger_samples_at_most_once():
    reports = []
    for dec, out, model in ((tdec, tout, tresidency.MODEL), (jdec, jout, jcost.residency.MODEL)):
        walls = iter((0.4, 0.9, 0.3, 0.6))

        def evict_and_join(kind):
            seq = dec.record_decision("pack_cache.evict", "lru", outcome=True, kind=kind,
                                      bytes=8192, target_bytes=0, rung="discard")
            out.resolve(seq, "pack_cache.evict", next(walls), engine="lru", regret_s=0.0)

        evict_and_join("agg")
        evict_and_join("agg")
        first = model.refit_from_outcomes()
        again = model.refit_from_outcomes()  # the same retained tail: a no-op
        evict_and_join("threshold")
        evict_and_join("agg")
        third = model.refit_from_outcomes()
        reports.append((first, again, third, model.to_dict()["repack_s"], model.to_dict()["samples"]))
    t, j = reports
    assert t == j
    first, again, third, repack, counts = t
    assert set(first["moved"]) == {"agg"} and first["samples"] == 2
    assert again["moved"] == {} and again["samples"] == 0
    assert set(third["moved"]) == {"agg", "threshold"} and counts == {"agg": 3, "threshold": 1}
    assert tcost.authority("pack-residency").drift() == jcost.authority("pack-residency").drift()
