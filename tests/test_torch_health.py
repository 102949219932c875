"""The port's health rules, sentinel, flight bundles and lock-wait stats
against the JAX package.

The same metric values go into a private registry of each package, the
same scripted timeline ticks both packages' sentinels on the same injected
clock, and the post-hysteresis rule levels, transitions, actuation kinds
and cooldown skips must be equal tick by tick; the windowed histogram
quantiles must be equal number for number. The one departure, the sign
rule of ``hbm-accounting-drift``'s device source, shows only with a device
source, which the JAX package never has on the CPU. Bundles are written
into ``tmp_path``; no test sleeps or reads a wall-clock threshold.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

import roaringbitmap_tpu.observe as jobs
from roaringbitmap_tpu import cost as jcost
from roaringbitmap_tpu.observe import bundle as jbundle
from roaringbitmap_tpu.observe import decisions as jdec
from roaringbitmap_tpu.observe import export as jexport
from roaringbitmap_tpu.observe import health as jhealth
from roaringbitmap_tpu.observe import outcomes as jout
from roaringbitmap_tpu.observe import sentinel as jsentinel
from roaringbitmap_tpu.observe.histogram import latency_histogram as jlatency
from roaringbitmap_tpu.observe.registry import Registry as JRegistry
from roaringbitmap_tpu.parallel import store as jstore
from roaringbitmap_tpu.robust import ladder as jladder

import roaringbitmap_tpu_torch.observe as tobs
from roaringbitmap_tpu_torch import FastAggregation as TFA
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch import cost as tcost
from roaringbitmap_tpu_torch import insights
from roaringbitmap_tpu_torch.observe import artifacts as tartifacts
from roaringbitmap_tpu_torch.observe import bundle as tbundle
from roaringbitmap_tpu_torch.observe import decisions as tdec
from roaringbitmap_tpu_torch.observe import export as texport
from roaringbitmap_tpu_torch.observe import health as thealth
from roaringbitmap_tpu_torch.observe import outcomes as tout
from roaringbitmap_tpu_torch.observe import sentinel as tsentinel
from roaringbitmap_tpu_torch.observe.histogram import latency_histogram as tlatency
from roaringbitmap_tpu_torch.observe import registry as treg
from roaringbitmap_tpu_torch.observe.registry import Registry as TRegistry
from roaringbitmap_tpu_torch.parallel import aggregation, store
from roaringbitmap_tpu_torch.robust import faults as tfaults
from roaringbitmap_tpu_torch.robust.errors import TransientDeviceError
from roaringbitmap_tpu_torch.robust import ladder as tladder


BOTH = (
    ("port", thealth, tsentinel, TRegistry, tlatency),
    ("jax", jhealth, jsentinel, JRegistry, jlatency),
)


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    """Both packages' sentinels, outcome ledgers, breakers and pack caches
    fresh; the port's device path on CPU tensors."""
    monkeypatch.setattr(aggregation.config, "device", "cpu")
    for mod in (tsentinel, jsentinel):
        mod.SENTINEL.reset()
        mod.configure(inline=False)
    for mod in (tout, jout):
        mod.reset()
    for lad in (tladder, jladder):
        lad.LADDER.reset()
    tfaults.clear()
    store.PACK_CACHE.close()
    jstore.PACK_CACHE.close()
    yield
    for mod in (tsentinel, jsentinel):
        mod.SENTINEL.reset()
        mod.configure(inline=False)
    for mod in (tout, jout):
        mod.reset()
    for lad in (tladder, jladder):
        lad.LADDER.reset()
    tfaults.clear()
    store.PACK_CACHE.close()
    jstore.PACK_CACHE.close()


class _Dial:
    """A probe whose value the test turns by hand."""

    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, snap):
        return self.value


def _stub(health_mod, **kw):
    return health_mod.Snapshot(
        metrics=kw.get("metrics", {}), breaker_open_ages=kw.get("ages", {}),
        drift=kw.get("drift", {}), outcome_sites=kw.get("sites", {}),
        now=kw.get("now", 0.0), prev_sums=kw.get("prev"),
    )


# ---------------------------------------------------------------------------
# the rule table and the hysteresis state machine
# ---------------------------------------------------------------------------


def _rule_row(r):
    return (r.name, r.warn, r.critical, r.fire_after, r.clear_after,
            r.flap_window, r.flap_limit, r.actuation)


def test_default_rule_table_is_the_jax_package_table():
    assert [_rule_row(r) for r in thealth.DEFAULT_RULES] == [
        _rule_row(r) for r in jhealth.DEFAULT_RULES
    ]
    assert len(thealth.DEFAULT_RULES) == 16
    assert (thealth.OK, thealth.WARN, thealth.CRITICAL) == (0, 1, 2)
    assert thealth.STATUS_NAMES == jhealth.STATUS_NAMES
    assert thealth.LEVEL_NAMES == jhealth.LEVEL_NAMES


# value scripts: warn / critical bands, fire_after, clear_after, a
# one-tick blip that must not fire, escalation and flapping
SCRIPTS = {
    "fire-and-clear": ([0, 5, 5, 5, 0, 0, 0], dict(fire_after=2, clear_after=2)),
    "blip-never-fires": ([0, 5, 0, 5, 0, 0], dict(fire_after=2, clear_after=2)),
    "escalate-to-critical": ([5, 5, 50, 50, 50, 5, 5, 0, 0, 0], dict(fire_after=2, clear_after=2)),
    "one-tick-fire": ([50, 0, 50, 50, 0], dict(fire_after=1, clear_after=1)),
    "slow-clear": ([5, 5, 5, 0, 0, 0, 0, 5], dict(fire_after=1, clear_after=4)),
    "flapping": ([0, 5, 0, 5, 0, 5, 0, 5, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                 dict(fire_after=1, clear_after=1, flap_window=8, flap_limit=3)),
    "no-data": ([None, 5, None, 5, 5, None, None], dict(fire_after=2, clear_after=2)),
}


def _run_script(health_mod, sentinel_mod, values, kw, actuation="alert"):
    dial = _Dial()
    rule = health_mod.Rule("r", "", dial, warn=1.0, critical=10.0,
                           actuation=actuation, **kw)
    s = sentinel_mod.Sentinel(rules=(rule,), clock=lambda: 0.0)
    out = []
    for i, v in enumerate(values):
        dial.value = v
        rep = s.tick(now=float(i), snap=_stub(health_mod))
        ev = rep["rules"]["r"]
        out.append((rep["status"], ev["raw"], ev["level"], ev["transition"],
                    ev["flapping"], ev["suppressed"],
                    [a["kind"] for a in rep["actuated"]]))
    return out, s.history("r"), s.rule_states()


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_rule_levels_tick_by_tick_match_the_jax_package(name):
    values, kw = SCRIPTS[name]
    got = _run_script(thealth, tsentinel, values, kw)
    want = _run_script(jhealth, jsentinel, values, kw)
    assert got == want


def test_none_and_probe_errors_judge_no_data_in_both():
    def boom(_snap):
        raise RuntimeError("probe broke")

    reports = []
    for _name, h, s, _r, _l in BOTH:
        rule = h.Rule("b", "", boom, warn=1.0, critical=2.0, fire_after=1)
        rep = s.Sentinel(rules=(rule,)).tick(now=0.0, snap=_stub(h))
        reports.append((rep["status"], rep["rules"]["b"]["level"], rep["probe_errors"]))
    assert reports[0] == reports[1]
    assert reports[0][2] == {"b": "RuntimeError: probe broke"}


# ---------------------------------------------------------------------------
# the default rules over the same registry values, on the same clock
# ---------------------------------------------------------------------------

# per tick: counter increments, gauge values, latency observations, breaker
# open ages, drift cells and per-site outcome rollups
TIMELINE = [
    dict(),
    dict(anomaly=3, compile=2, queued=5, batches=1, lat=[0.01] * 10,
         ages={"agg/device": 12.0}, drift={"and/columnar-cpu/run": 1.5},
         sites={"columnar.cutoff": {"regret_s": 0.01, "measured_s": 1.0}}),
    dict(anomaly=20, compile=40, queued=5, batches=0, lat=[0.9] * 20,
         admit={("t1", "shed"): 9, ("t1", "admitted"): 3}, structure=1.6,
         accretion=10, ages={"agg/device": 45.0}, drift={"and/columnar-cpu/run": 3.0},
         sites={"columnar.cutoff": {"regret_s": 0.3, "measured_s": 1.0}}),
    dict(anomaly=20, compile=9, queued=70, batches=0, lat=[3.0] * 20,
         admit={("t1", "shed"): 12, ("t1", "admitted"): 0}, structure=2.5,
         accretion=70, ages={"agg/device": 400.0}, drift={"or/columnar-device/bitmap": 0.2},
         sites={"columnar.cutoff": {"regret_s": 0.5, "measured_s": 1.0}}, mutlog=70,
         ledger_drift=3),
    dict(anomaly=0, compile=0, queued=70, batches=2, lat=[0.001] * 5, structure=1.0,
         accretion=0, ages={}, drift={"or/columnar-device/bitmap": 1.0},
         sites={"columnar.cutoff": {"regret_s": 0.0, "measured_s": 10.0}}, mutlog=0,
         ledger_drift=0),
    dict(),
    dict(lat=[0.002] * 3, queued=0, batches=1),
    dict(),
]


def _registry_for(reg_cls, latency):
    reg = reg_cls()
    m = {
        "anomaly": reg.counter(tobs.OUTCOME_ANOMALY_TOTAL, "", ("site",)),
        "compile": reg.counter(tobs.COMPILE_TOTAL, "", ("fn",)),
        "queued": reg.gauge(tobs.FUSION_QUEUED_COUNT, ""),
        "batches": reg.counter(tobs.FUSION_BATCH_TOTAL, "", ("outcome",)),
        "lat": latency(treg.SERVE_LATENCY_SECONDS, "", ("tenant", "phase"), registry=reg),
        "budget": reg.gauge(treg.SERVE_SLO_BUDGET_SECONDS, "", ("tenant",)),
        "admit": reg.counter(treg.SERVE_ADMIT_TOTAL, "", ("tenant", "verdict")),
        "structure": reg.gauge(tobs.STRUCTURE_DRIFT_RATIO, ""),
        "accretion": reg.gauge(tobs.STRUCTURE_ACCRETION_COUNT, ""),
        "mutlog": reg.gauge(treg.SERVE_MUTLOG_COUNT, ""),
        "drift": reg.gauge(tobs.HBM_ACCOUNTING_DRIFT_BYTES, "", ("source",)),
    }
    m["budget"].set(0.05, ("t1",))
    return reg, m


def _apply(m, step):
    if "anomaly" in step:
        m["anomaly"].inc(step["anomaly"], ("columnar.cutoff",))
    if "compile" in step:
        m["compile"].inc(step["compile"], ("rb_kernels",))
    if "queued" in step:
        m["queued"].set(step["queued"])
    if "batches" in step:
        m["batches"].inc(step["batches"], ("fused",))
    for v in step.get("lat", ()):
        m["lat"].observe(v, ("t1", "execute"))
    for lv, n in step.get("admit", {}).items():
        m["admit"].inc(n, lv)
    if "structure" in step:
        m["structure"].set(step["structure"])
    if "accretion" in step:
        m["accretion"].set(step["accretion"])
    if "mutlog" in step:
        m["mutlog"].set(step["mutlog"])
    if "ledger_drift" in step:
        m["drift"].set(step["ledger_drift"], ("ledger",))


def _drive_default_rules(health_mod, sentinel_mod, reg_cls, latency, actuations):
    reg, m = _registry_for(reg_cls, latency)
    s = sentinel_mod.Sentinel(clock=lambda: 0.0)
    # the closed-loop targets are stubbed alike in both packages: this
    # compares the judgement and the actuation schedule, not the targets
    s._actuate_refit = lambda now, tick, rule: {"tick": tick, "kind": "refit", "rule": rule}
    s._actuate_maintain = lambda now, tick, rule: {"tick": tick, "kind": "maintain", "rule": rule}
    s._actuate_autotune = lambda now, tick, rule: {"tick": tick, "kind": "autotune", "rule": rule}
    s._actuate_bundle = lambda now, tick, rules, evals: {"tick": tick, "kind": "bundle", "rules": list(rules)}
    out = []
    for i, step in enumerate(TIMELINE):
        _apply(m, step)
        snap = health_mod.Snapshot(
            metrics=reg.snapshot(), breaker_open_ages=step.get("ages", {}),
            drift=step.get("drift", {}), outcome_sites=step.get("sites", {}),
            now=float(i), prev_sums=dict(s._prev_sums),
        )
        rep = s.tick(now=float(i * 20), snap=snap)
        out.append((rep["status"], {k: (v["value"], v["level"], v["transition"])
                                    for k, v in rep["rules"].items()}))
        actuations.append([(a["kind"], a.get("rule"), a.get("rules")) for a in rep["actuated"]])
    return out


def test_default_rules_over_the_same_timeline_match_the_jax_package():
    t_act, j_act = [], []
    got = _drive_default_rules(thealth, tsentinel, TRegistry, tlatency, t_act)
    want = _drive_default_rules(jhealth, jsentinel, JRegistry, jlatency, j_act)
    assert got == want
    assert t_act == j_act
    # the timeline reaches every level and every actuation kind
    assert {st for st, _ in got} == {0, 1, 2}
    kinds = {k for tick in t_act for k, _r, _rs in tick}
    assert kinds == {"alert", "refit", "maintain", "autotune", "bundle"}


@pytest.mark.parametrize("q", [0.5, 0.9, 0.99, 0.999])
@pytest.mark.parametrize("seed", [3, 11])
def test_windowed_quantiles_match_the_jax_package(q, seed):
    rng = np.random.default_rng(seed)
    ticks = [rng.lognormal(-4, 1.5, rng.integers(0, 40)).tolist() for _ in range(6)]
    ticks[2] = []  # an idle window: no series moved
    results = []
    for _name, h, _s, reg_cls, latency in BOTH:
        reg = reg_cls()
        hist = latency("rb_tpu_serve_latency_seconds", "", ("tenant", "phase"), registry=reg)
        prev, per_tick = {}, []
        for vals in ticks:
            for v in vals:
                hist.observe(v, ("a" if v < 0.02 else "b", "execute"))
            snap = _stub(h, metrics=reg.snapshot(), prev=prev)
            per_tick.append((snap.histogram_delta_quantiles(treg.SERVE_LATENCY_SECONDS, q),
                             snap.histogram_delta_quantile(treg.SERVE_LATENCY_SECONDS, q)))
            prev = dict(prev, **snap.sums)
        results.append(per_tick)
    assert results[0] == results[1]
    assert results[0][0] == ({}, None)  # the first tick reports no window


# ---------------------------------------------------------------------------
# the departure: hbm-accounting-drift judges the device source by its sign
# ---------------------------------------------------------------------------


def _drift_snapshot(h, reg_cls, **sources):
    reg = reg_cls()
    g = reg.gauge(tobs.HBM_ACCOUNTING_DRIFT_BYTES, "", ("source",))
    for src, v in sources.items():
        g.set(v, (src,))
    return _stub(h, metrics=reg.snapshot())


def _hbm_rule(h):
    return next(r for r in h.DEFAULT_RULES if r.name == "hbm-accounting-drift")


@pytest.mark.parametrize("device,port_band,jax_band", [
    (-(700 << 20), 0, 2),   # the card holds more than the pack cache
    (-1, 0, 1),
    (0, 0, 0),
    (1, 1, 1),              # the gauge claims memory the card freed
    (5 << 20, 2, 2),
])
def test_hbm_drift_device_source_is_judged_by_its_sign(device, port_band, jax_band):
    t_rule, j_rule = _hbm_rule(thealth), _hbm_rule(jhealth)
    t_val = t_rule.probe(_drift_snapshot(thealth, TRegistry, ledger=0, device=device))
    j_val = j_rule.probe(_drift_snapshot(jhealth, JRegistry, ledger=0, device=device))
    assert t_rule.band(t_val) == port_band
    assert j_rule.band(j_val) == jax_band


@pytest.mark.parametrize("ledger", [0, 1, -1, 3 << 20, -(3 << 20)])
def test_hbm_drift_ledger_source_matches_the_jax_package(ledger):
    t_rule, j_rule = _hbm_rule(thealth), _hbm_rule(jhealth)
    t_val = t_rule.probe(_drift_snapshot(thealth, TRegistry, ledger=ledger))
    j_val = j_rule.probe(_drift_snapshot(jhealth, JRegistry, ledger=ledger))
    assert t_val == j_val and t_rule.band(t_val) == j_rule.band(j_val)


# ---------------------------------------------------------------------------
# the sentinel: actuations, cooldowns, the missing targets, pacing
# ---------------------------------------------------------------------------


def _actuation_script(health_mod, sentinel_mod, actuation, stub_targets):
    dial = _Dial(5.0)
    rule = health_mod.Rule("r", "", dial, warn=1.0, critical=100.0,
                           fire_after=1, clear_after=1, actuation=actuation)
    s = sentinel_mod.Sentinel(rules=(rule,), clock=lambda: 0.0, refit_cooldown_s=60.0,
                              maintain_cooldown_s=30.0, autotune_cooldown_s=30.0)
    for name in stub_targets:
        setattr(s, name, stub_targets[name](s))
    ticks = []
    for now in (0.0, 1.0, 29.0, 31.0, 59.0, 61.0, 62.0):
        rep = s.tick(now=now, snap=_stub(health_mod))
        ticks.append([a["kind"] for a in rep["actuated"]])
    dial.value = 0.0
    ticks.append([a["kind"] for a in s.tick(now=200.0, snap=_stub(health_mod))["actuated"]])
    return ticks, s.actuations()


def _maintained_store(pkg):
    """An epoch store over a drifted corpus (long runs held as bitmap and
    array containers) with the corpus watched by the structure ledger: the
    current store a real maintenance pass runs on."""
    import itertools

    if pkg == "port":
        from roaringbitmap_tpu_torch.observe import structure
        from roaringbitmap_tpu_torch.serve import EpochStore, ingest, maintain
        RB = TRB
    else:
        from roaringbitmap_tpu.models.roaring import RoaringBitmap as RB
        from roaringbitmap_tpu.observe import structure
        from roaringbitmap_tpu.serve import EpochStore, ingest, maintain
    ingest._BATCH_IDS = itertools.count(1)
    structure.LEDGER.reset()
    maintain.reset()
    # twelve long runs held as bitmap containers: ~96 KiB over optimal,
    # enough that the priced verdict compacts
    corpus = [RB(np.concatenate([np.arange(((3 * i + k) << 16) + 50, ((3 * i + k) << 16) + 20050)
                                 for k in range(3)]).astype(np.uint32)) for i in range(4)]
    structure.LEDGER.watch("health", corpus)
    return EpochStore(corpus, clock=lambda: 3.0), structure, maintain


@pytest.mark.parametrize("actuation", ["refit", "maintain", "autotune", "alert"])
def test_actuation_kinds_and_cooldown_skips_match_the_jax_package(actuation, monkeypatch):
    # refit and autotune stubbed alike in both packages, so their schedule
    # is compared; maintain runs real passes over each package's own
    # epoch store
    from roaringbitmap_tpu.query import fusion as jfusion
    from roaringbitmap_tpu_torch.query import fusion as tfusion

    for cost_mod in (jcost, tcost):
        monkeypatch.setattr(cost_mod, "refit_all", lambda: {})
    for fusion_mod in (jfusion, tfusion):
        monkeypatch.setattr(fusion_mod, "autotune_window", lambda reason=None: {"verdict": "hold"})
    keep = []
    if actuation == "maintain":
        keep.append(_maintained_store("port"))
    got, t_log = _actuation_script(thealth, tsentinel, actuation, {})
    if actuation == "maintain":
        keep.append(_maintained_store("jax"))
    want, j_log = _actuation_script(jhealth, jsentinel, actuation, {})
    assert got == want
    # every target is reached, as in the JAX package
    assert t_log and not any("error" in e for e in t_log)
    assert _drop(t_log) == _drop(j_log)
    if actuation == "maintain":
        outcomes = [e["outcome"] for e in t_log]
        assert outcomes[0] == "compacted" and t_log[0]["rewritten_keys"] > 0
        for es, structure, maintain in keep:
            assert es.current() >= 1
            structure.LEDGER.reset()
            maintain.reset()


@pytest.mark.parametrize("rule_name", [
    "costmodel-drift", "structure-drift", "delta-accretion", "serving-p99-pressure",
])
def test_missing_targets_record_their_error_and_the_rule_stays_firing(rule_name, monkeypatch):
    """Every actuation now reaches its target. ``refit`` (costmodel-drift)
    and ``autotune`` (serving-p99-pressure) are stubbed as the JAX
    package's tests stub them; ``maintain`` (structure-drift,
    delta-accretion) runs a real pass, whose record equals the JAX
    package's pass on the same corpus. No error, and the rule clears once
    the target has moved what it judges."""
    from roaringbitmap_tpu_torch.query import fusion as tfusion
    from roaringbitmap_tpu_torch.serve import maintain as tmaintain

    base = next(r for r in thealth.DEFAULT_RULES if r.name == rule_name)
    dial = _Dial(base.critical * 2)
    calls = []

    def target(*_a, **_kw):  # the refit / autotune re-bases what the rule reads
        calls.append(1)
        dial.value = 0.0
        return {} if base.actuation == "refit" else {"verdict": "shrink", "window_from": 8,
                                                     "window_to": 2, "budget_ms": 25.0}

    real_pass = tmaintain.run_pass
    passes = []

    def maintain_target(*a, **kw):  # a real pass; then the drift it judged is gone
        rec = real_pass(*a, **kw)
        passes.append(rec)
        calls.append(1)
        dial.value = 0.0
        return rec

    monkeypatch.setattr(tcost, "refit_all", target)
    monkeypatch.setattr(tfusion, "autotune_window", target)
    monkeypatch.setattr(tmaintain, "run_pass", maintain_target)
    keep = _maintained_store("port") if base.actuation == "maintain" else None
    rule = thealth.Rule(base.name, base.help, dial, warn=base.warn, critical=base.critical,
                        fire_after=1, clear_after=1, actuation=base.actuation)
    s = tsentinel.Sentinel(rules=(rule,), clock=lambda: 0.0)
    s._actuate_bundle = lambda now, tick, rules, evals: {"tick": tick, "kind": "bundle"}
    first = s.tick(now=0.0, snap=_stub(thealth))
    acted = [a for a in first["actuated"] if a["kind"] == base.actuation]
    second = s.tick(now=1000.0, snap=_stub(thealth))
    assert len(acted) == 1 and "error" not in acted[0] and calls == [1]
    if base.actuation == "autotune":
        assert acted[0]["verdict"] == "shrink" and acted[0]["window_to"] == 2
    if base.actuation == "maintain":
        from roaringbitmap_tpu.serve import maintain as jmaintain

        jes, jstructure, _jm = _maintained_store("jax")
        want = jmaintain.run_pass(jes, reason=f"sentinel:{rule_name}")
        assert _drop(passes, ("wall_s",)) == [_drop(want, ("wall_s",))]
        assert acted[0]["outcome"] == "compacted" == want["outcome"]
        assert acted[0]["reclaimed_bytes"] == want["reclaimed_bytes"] > 0
        jstructure.LEDGER.reset()
        jmaintain.reset()
        keep[1].LEDGER.reset()
        keep[2].reset()
    assert second["rules"][rule_name]["level"] == thealth.OK
    assert second["actuated"] == []


def test_bundle_once_per_red_episode_matches_the_jax_package():
    kinds = []
    for _name, h, s_mod, _r, _l in BOTH:
        dial = _Dial(500.0)
        rule = h.Rule("r", "", dial, warn=10.0, critical=100.0, fire_after=1, clear_after=1)
        s = s_mod.Sentinel(rules=(rule,), clock=lambda: 0.0, bundle_cooldown_s=300.0)
        s._actuate_bundle = lambda now, tick, rules, evals: {"tick": tick, "kind": "bundle"}
        seq = []
        for now, v in ((0, 500), (1, 500), (2, 0), (3, 500), (400, 0), (401, 500)):
            dial.value = v
            seq.append([a["kind"] for a in s.tick(now=float(now), snap=_stub(h))["actuated"]])
        kinds.append(seq)
    assert kinds[0] == kinds[1]
    assert kinds[0] == [["bundle"], [], [], [], [], ["bundle"]]


def test_health_gauges_and_insights_block():
    dial = _Dial(50.0)
    rule = thealth.Rule("gauge-rule", "", dial, warn=10.0, critical=100.0, fire_after=1)
    tsentinel.Sentinel(rules=(rule,)).tick(now=0.0, snap=_stub(thealth))
    assert tobs.REGISTRY.get(tobs.HEALTH_STATUS).get(()) == thealth.WARN
    assert tobs.REGISTRY.get(tobs.HEALTH_RULE_STATE).get(("gauge-rule",)) == thealth.WARN
    tsentinel.SENTINEL.tick(now=0.0)
    h = insights.health()
    assert h["status_name"] == "green" and len(h["rules"]) == 16
    assert not h["sentinel_running"]
    block = texport.sidecar_snapshot()["health"]
    assert block["status"] == 0 and block["status_name"] == "green"


def test_sidecar_health_and_fusion_blocks_match_the_jax_package():
    blocks = []
    for _name, _h, _s, reg_cls, latency in BOTH:
        reg = reg_cls()
        reg.gauge(tobs.HEALTH_STATUS, "").set(2)
        st = reg.gauge(tobs.HEALTH_RULE_STATE, "", ("rule",))
        st.set(1, ("routing-regret",))
        st.set(2, ("breaker-stuck-open",))
        reg.counter(tobs.HEALTH_ACTUATION_TOTAL, "", ("rule", "kind")).inc(2, ("breaker-stuck-open", "alert"))
        reg.counter(tobs.FUSION_BATCH_TOTAL, "", ("outcome",)).inc(3, ("fused",))
        reg.counter(tobs.FUSION_QUERIES_TOTAL, "").inc(24)
        steps = reg.counter(tobs.FUSION_STEPS_TOTAL, "", ("kind",))
        steps.inc(40, ("executed",))
        steps.inc(8, ("deduped",))
        steps.inc(30, ("merged",))
        reg.gauge(tobs.FUSION_QUEUED_COUNT, "").set(4)
        reg.gauge(tobs.FUSION_WINDOW_COUNT, "").set(8)
        reg.counter(tobs.QUERY_INFLIGHT_TOTAL, "", ("event",)).inc(5, ("lead",))
        exp = texport if _name == "port" else jexport
        snap = reg.snapshot()
        blocks.append((exp._health_block(snap), exp._fusion_block(snap)))
    assert blocks[0] == blocks[1]


def test_inline_hook_off_is_one_check_and_on_rides_the_dispatch(monkeypatch):
    ticks = []
    monkeypatch.setattr(tsentinel.SENTINEL, "tick", lambda *a, **kw: ticks.append(1))
    a, b = TRB(np.arange(0, 5000, 3, dtype=np.uint32)), TRB(np.arange(7, 9000, 5, dtype=np.uint32))
    tsentinel.configure(inline=False)
    assert tsentinel.maybe_tick() is False
    TFA.or_(a, b, mode="cpu")
    assert ticks == []
    tsentinel.configure(inline=True, inline_interval_s=0.0)
    try:
        TFA.or_(a, b, mode="cpu")
        TFA.or_(a, b, mode="device", device="cpu")
    finally:
        tsentinel.configure(inline=False, inline_interval_s=tsentinel.DEFAULT_INTERVAL_S)
    assert len(ticks) == 2


def test_background_thread_ticks_and_stops():
    ticked = threading.Event()
    orig = tsentinel.SENTINEL.tick

    def tick(*a, **kw):
        ticked.set()
        return orig(*a, **kw)

    tsentinel.SENTINEL.tick = tick
    try:
        tsentinel.start(interval_s=0.01)
        assert tsentinel.running()
        assert ticked.wait(timeout=30.0)
    finally:
        tsentinel.stop()
        del tsentinel.SENTINEL.tick
    assert not tsentinel.running()


def test_default_tick_is_green_with_a_resident_pack():
    bms = [TRB(np.arange(i, 300000, 7 + i, dtype=np.uint32)) for i in range(6)]
    TFA.or_(*bms, mode="device", device="cpu")
    assert len(store.PACK_CACHE) == 1
    r1 = tsentinel.SENTINEL.tick(now=0.0)
    r2 = tsentinel.SENTINEL.tick(now=1.0)
    assert r1["status_name"] == r2["status_name"] == "green"
    assert r2["rules"]["hbm-accounting-drift"]["value"] == 0.0
    drift = tobs.REGISTRY.get(tobs.HBM_ACCOUNTING_DRIFT_BYTES)
    assert drift.get(("ledger",)) == 0


# ---------------------------------------------------------------------------
# flight bundles
# ---------------------------------------------------------------------------


def _sections(path):
    return sorted(n for n in os.listdir(path) if n != "MANIFEST.json")


def test_bundle_sections_are_the_jax_set_less_the_unported(tmp_path):
    t = tbundle.write_bundle("t", trigger={"tick": 1}, dir=str(tmp_path / "t"))
    j = jbundle.write_bundle("t", trigger={"tick": 1}, dir=str(tmp_path / "j"))
    assert set(_sections(t)) == set(_sections(j))
    obs = json.loads(open(os.path.join(t, "observatory.json")).read())
    jobs_ = json.loads(open(os.path.join(j, "observatory.json")).read())
    assert "error" not in obs
    assert set(obs) == set(jobs_)
    for panel in ("epochs", "structure", "durable"):
        assert set(obs[panel]) == set(jobs_[panel])
    assert set(obs["serving"]) == set(jobs_["serving"])
    cal = json.loads(open(os.path.join(t, "calibration.json")).read())
    jcal = json.loads(open(os.path.join(j, "calibration.json")).read())
    assert cal["schema"] == jcal["schema"] and set(cal["authorities"]) == set(jcal["authorities"])
    assert obs["hbm"]["ledger_drift_bytes"] == 0 and "device_drift_bytes" not in obs["hbm"]
    manifest = tbundle.read_manifest(t, verify=True)
    assert manifest["schema"] == jbundle.SCHEMA and manifest["trigger"] == {"tick": 1}
    assert sorted(manifest["files"]) == _sections(t)


def _deterministic(path, name):
    text = open(os.path.join(path, name)).read()
    if name.endswith(".jsonl"):
        return [json.loads(line) for line in text.splitlines() if line]
    return json.loads(text)


def _drop(obj, keys=("ts_ns", "seq", "trace", "ts")):
    if isinstance(obj, dict):
        return {k: _drop(v, keys) for k, v in obj.items() if k not in keys}
    if isinstance(obj, list):
        return [_drop(v, keys) for v in obj]
    return obj


def test_bundle_deterministic_sections_match_the_jax_package(tmp_path):
    names = (tobs.DECISION_TOTAL, tobs.OUTCOME_JOIN_TOTAL, tobs.DECISION_REGRET_SECONDS,
             tobs.DECISION_ERROR_RATIO, tobs.OUTCOME_ANOMALY_TOTAL)
    paths = []
    for label, dec, out, obs, bun in (("t", tdec, tout, tobs, tbundle),
                                      ("j", jdec, jout, jobs, jbundle)):
        dec.LOG.clear()
        for n in names:
            obs.REGISTRY.get(n).clear()
        for i, (engine, measured) in enumerate((("columnar-cpu", 0.0004), ("per-container", 0.002),
                                                 ("columnar-cpu", 0.00005))):
            seq = dec.record_decision(
                "columnar.cutoff", engine, outcome=True, op="or", shape="run", na=40 + i, nb=50,
                est_us={"per-container": 900.0, "columnar-cpu": 300.0},
            )
            out.resolve(seq, "columnar.cutoff", measured, engine=engine)
        dec.record_decision("pack_cache.admit", "resident", kind="agg", bytes=8192)
        paths.append(bun.write_bundle("r", dir=str(tmp_path / label)))
    t, j = paths
    assert _drop(_deterministic(t, "decisions.json")) == _drop(_deterministic(j, "decisions.json"))
    t_out, j_out = _deterministic(t, "outcomes.json"), _deterministic(j, "outcomes.json")
    assert _drop(t_out) == _drop(j_out)
    assert t_out["drift"] and t_out["summary"]["columnar.cutoff"]["count"] == 3

    def metric_lines(path):
        return [e for e in _deterministic(path, "metrics.jsonl") if e.get("name") in names]

    assert metric_lines(t) == metric_lines(j)
    assert metric_lines(t)


def test_bundle_manifest_verifies_and_detects_tampering(tmp_path):
    path = tbundle.write_bundle("tamper", dir=str(tmp_path))
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp-")]
    tbundle.read_manifest(path, verify=True)
    with open(os.path.join(path, "decisions.json"), "ab") as f:
        f.write(b" ")
    with pytest.raises(ValueError, match="bytes"):
        tbundle.read_manifest(path, verify=True)
    tbundle.read_manifest(path, verify=False)  # presence only
    os.remove(os.path.join(path, "health.json"))
    with pytest.raises(ValueError, match="missing"):
        tbundle.read_manifest(path, verify=False)


def test_red_episode_writes_one_verified_bundle_into_the_sink(tmp_path):
    """A breaker held open by ``store.ship`` faults past the stuck-open
    band: the sentinel goes red and writes one verified bundle into the
    sink; staying red writes no second one."""
    import time

    prev = tartifacts.artifact_dir()
    tartifacts.configure(dir=str(tmp_path))
    tladder.LADDER.configure(trip_after=1)
    try:
        bms = [TRB(np.arange(i, 200000, 5 + i, dtype=np.uint32)) for i in range(4)]
        with tfaults.inject("store.ship", every=1):
            with pytest.raises(TransientDeviceError):
                TFA.or_(*bms, mode="device", device="cpu")
        assert tladder.LADDER.states() == {"agg/device": "open"}
        # the open age, read on an injected clock 400 s after the trip
        ages = tladder.LADDER.open_ages(now=time.monotonic() + 400.0)
        assert min(ages.values()) >= 400.0

        def tick(now):
            snap = thealth.snapshot(prev_sums=dict(tsentinel.SENTINEL._prev_sums), now=now)
            snap.breaker_open_ages = ages
            return tsentinel.SENTINEL.tick(now=now, snap=snap)

        red = tick(1000.0)
        assert red["status_name"] == "red"
        assert red["rules"]["breaker-stuck-open"]["level"] == thealth.CRITICAL
        bundles = [a for a in red["actuated"] if a["kind"] == "bundle"]
        assert len(bundles) == 1 and "error" not in bundles[0]
        path = bundles[0]["path"]
        assert os.path.dirname(path) == str(tmp_path)
        manifest = tbundle.read_manifest(path, verify=True)
        assert "breaker-stuck-open" in manifest["trigger"]["rules"]
        assert set(manifest["files"]) == {
            "timeline.jsonl", "decisions.json", "outcomes.json", "metrics.jsonl",
            "calibration.json", "observatory.json", "health.json",
        }
        cal = json.loads(open(os.path.join(path, "calibration.json")).read())
        assert sorted(cal["authorities"]) == tcost.names() and len(tcost.names()) == 8
        dump = json.loads(open(os.path.join(path, "health.json")).read())
        assert dump["status_name"] == "red"
        obs = json.loads(open(os.path.join(path, "observatory.json")).read())
        assert obs["breakers"] == {"agg/device": "open"} and obs["hbm"]["ledger_drift_bytes"] == 0
        again = tick(1001.0)
        assert not [a for a in again["actuated"] if a["kind"] == "bundle"]
        assert [n for n in os.listdir(tmp_path) if n.startswith("bundle_")] == [os.path.basename(path)]
    finally:
        tartifacts.configure(dir=prev)
        tladder.LADDER.configure(trip_after=3)
        tladder.LADDER.reset()


@pytest.mark.cuda
def test_cuda_red_episode_bundle_carries_the_device_reconciliation(tmp_path, monkeypatch):
    """Phase 17 (c) on the card: with a resident pack on the card, a red
    tick writes one bundle whose observatory holds the reconciliation's
    device keys, the device drift at or below zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    monkeypatch.setattr(aggregation.config, "device", "cuda")
    bms = [TRB(np.arange(i, 3_000_000, 5 + i, dtype=np.uint32)) for i in range(8)]
    TFA.or_(*bms, mode="device")
    torch.cuda.synchronize()
    rule = thealth.Rule("forced-red", "", _Dial(1.0), warn=0.5, critical=1.0, fire_after=1)
    s = tsentinel.Sentinel(rules=(rule,) + thealth.DEFAULT_RULES, clock=lambda: 0.0)
    prev = tartifacts.artifact_dir()
    tartifacts.configure(dir=str(tmp_path))
    try:
        rep = s.tick(now=0.0)
    finally:
        tartifacts.configure(dir=prev)
    assert rep["rules"]["hbm-accounting-drift"]["level"] == thealth.OK
    bundles = [a for a in rep["actuated"] if a["kind"] == "bundle"]
    assert len(bundles) == 1
    path = bundles[0]["path"]
    tbundle.read_manifest(path, verify=True)
    hbm = json.loads(open(os.path.join(path, "observatory.json")).read())["hbm"]
    assert hbm["ledger_drift_bytes"] == 0 and hbm["device_drift_bytes"] <= 0
    store.PACK_CACHE.close()


# ---------------------------------------------------------------------------
# lock-wait stats
# ---------------------------------------------------------------------------

PORT_LOCKS = ["agg.pool", "native.loader", "observe.registry", "query.cache",
              "query.exec.plan_memo", "query.expr.intern"]


def test_lockstats_installs_six_locks_and_restores_them():
    from roaringbitmap_tpu.observe import lockstats as jlockstats
    from roaringbitmap_tpu_torch.observe import lockstats

    raw = {name: get() for name, get, _set in lockstats._framework_locks()}
    lockstats.install()
    try:
        assert lockstats.installed() == PORT_LOCKS
        jnames = {name for name, _g, _s in jlockstats._framework_locks()}
        assert set(PORT_LOCKS) == jnames - {"tracing.timings"}
        for name, get, _set in lockstats._framework_locks():
            wrapped = get()
            assert isinstance(wrapped, lockstats.TimedLock) and wrapped._inner is raw[name]
            with wrapped:
                pass
            assert wrapped.acquire(False)
            wrapped.release()
        reg = tobs.REGISTRY._lock
        with reg:
            with reg:  # the wrapped registry lock stays reentrant
                tobs.REGISTRY.get(tobs.HEALTH_STATUS).set(0)
        assert all(m._lock is reg for m in tobs.REGISTRY.metrics())
        TFA.or_(TRB([1, 2, 3]), TRB([5, 70000]), mode="cpu")
        stats = lockstats.wait_stats()
        assert "observe.registry" in stats and stats["observe.registry"]["count"] > 0
        assert {"count", "sum", "p50", "p90", "p99"} <= set(stats["observe.registry"])
    finally:
        lockstats.uninstall()
    assert lockstats.installed() == [] and not lockstats.timing_enabled()
    for name, get, _set in lockstats._framework_locks():
        assert get() is raw[name]
    assert all(m._lock is raw["observe.registry"] for m in tobs.REGISTRY.metrics())


def test_lockstats_sampling_and_timing_toggle():
    from roaringbitmap_tpu_torch.observe import lockstats

    inner = threading.RLock()
    lock = lockstats.TimedLock("probe.lock", inner)
    lockstats.enable(True, sample=2)
    try:
        for _ in range(10):
            with lock:
                with lock:  # reentrant through the proxy
                    pass
        n = lockstats.wait_stats().get("probe.lock", {}).get("count", 0)
        assert n == 10  # 20 acquisitions, every second one timed
    finally:
        lockstats.enable(False)
    with pytest.raises(ValueError):
        lockstats.enable(True, sample=0)
    with lock:
        pass
    assert lockstats.wait_stats()["probe.lock"]["count"] == n


def test_lockstats_wrapped_locks_serve_a_thread_hammer():
    from roaringbitmap_tpu_torch.observe import lockstats
    from roaringbitmap_tpu_torch.query import cache as qcache

    lockstats.install()
    errors = []
    try:
        def work(i):
            try:
                for j in range(50):
                    tobs.REGISTRY.get(tobs.HEALTH_STATUS).set(0)
                    with qcache.DEFAULT_CACHE._lock:
                        pass
            except Exception as e:  # surfaced by the assert below
                errors.append(repr(e))

        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        lockstats.uninstall()
    assert not errors
    assert lockstats.wait_stats()["query.cache"]["count"] >= 8 * 50


def test_observatory_snapshot_shape():
    obs = insights.observatory()
    assert set(obs) == {"locks", "lock_timing", "compile", "hbm", "breakers",
                        "pack_cache", "decisions", "regret", "health", "serving",
                        "epochs", "structure", "durable"}
    assert obs["hbm"]["ledger_drift_bytes"] == 0
    assert isinstance(obs["decisions"], list)
