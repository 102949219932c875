"""The port's fault model (``roaringbitmap_tpu_torch.robust``) against the
JAX package's, mirroring ``tests/test_robust.py``.

``classify`` agrees with the JAX package on the same exception kinds (and
maps ``torch.cuda.OutOfMemoryError`` to ``"resource"``); the same schedule
spec fires at the same hits in both packages; the backoff jitter and the
breaker transitions are equal; deadlines nest; the breaker survives a
thread hammer; every fault site the port lists fires through its real
call path. The departures are held both ways: a device tier is the last
of its ladder list, so an injected ``simulated_oom`` at ``store.expand``
or a fault at ``ops.dispatch`` raises in the port where the JAX package
answers from a lower tier; a transient ``store.ship`` fault is retried on
the device and the result is exact in both. The port's device path runs
on CPU tensors (``aggregation.config.device = "cpu"``).
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

import roaringbitmap_tpu.observe as jobs
from roaringbitmap_tpu import robust as jrobust
from roaringbitmap_tpu.models.roaring import RoaringBitmap as JRB
from roaringbitmap_tpu.parallel import store as jstore
from roaringbitmap_tpu.parallel.aggregation import FastAggregation as JFA
from roaringbitmap_tpu.robust import errors as jerrors
from roaringbitmap_tpu.robust import faults as jfaults
from roaringbitmap_tpu.robust import ladder as jladder

import roaringbitmap_tpu_torch.observe as tobs
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch import columnar as tcolumnar
from roaringbitmap_tpu_torch import insights
from roaringbitmap_tpu_torch import query as tq
from roaringbitmap_tpu_torch import robust as trobust
from roaringbitmap_tpu_torch.parallel import aggregation, store
from roaringbitmap_tpu_torch.parallel.aggregation import FastAggregation as TFA
from roaringbitmap_tpu_torch.robust import errors as terrors
from roaringbitmap_tpu_torch.robust import faults as tfaults
from roaringbitmap_tpu_torch.robust import ladder as tladder

ROBUST = {"port": trobust, "jax": jrobust}
ERRORS = {"port": terrors, "jax": jerrors}
LADDER = {"port": tladder, "jax": jladder}


def _reset():
    for f, lad in ((tfaults, tladder), (jfaults, jladder)):
        f.clear()
        lad.LADDER.reset()
        lad.LADDER.configure(trip_after=3, cooldown_s=5.0)
    store.PACK_CACHE.close()
    jstore.PACK_CACHE.close()


@pytest.fixture(autouse=True)
def fresh_robust_state(monkeypatch):
    """No armed faults, closed breakers, default policy, empty pack caches,
    and the port's device path on CPU tensors."""
    monkeypatch.setattr(aggregation.config, "device", "cpu")
    _reset()
    yield
    _reset()


def _values(n=4, seed=7):
    rng = np.random.default_rng(seed)
    return [np.sort(rng.choice(1 << 20, 4000, replace=False)).astype(np.uint32) for _ in range(n)]


def _both(n=4, seed=7):
    vals = _values(n, seed)
    return [TRB(v) for v in vals], [JRB(v) for v in vals]


def _series(o, name):
    m = o.REGISTRY.get(name)
    return m.series() if m else {}


# ---------------------------------------------------------------------------
# taxonomy
# ---------------------------------------------------------------------------

KINDS = {
    "transient-class": lambda r: r.TransientDeviceError("x"),
    "resource-class": lambda r: r.ResourceExhausted("x"),
    "unavailable-class": lambda r: r.TierUnavailable("x"),
    "deadline-class": lambda r: r.DeadlineExceeded("x"),
    "runtime-resource-marker": lambda r: RuntimeError("RESOURCE_EXHAUSTED: device"),
    "runtime-oom-text": lambda r: RuntimeError("CUDA out of memory. Tried to allocate 2 GiB"),
    "runtime-other": lambda r: RuntimeError("CUDA error: unspecified launch failure"),
    "memory-error": lambda r: MemoryError(),
    "connection": lambda r: ConnectionError("reset"),
    "timeout": lambda r: TimeoutError("slow"),
    "interrupted": lambda r: InterruptedError("eintr"),
    "file-not-found": lambda r: FileNotFoundError("missing"),
    "bare-oserror": lambda r: OSError("io"),
    "value-error": lambda r: ValueError("bug"),
    "type-error": lambda r: TypeError("bug"),
    "key-error": lambda r: KeyError("bug"),
    "assertion": lambda r: AssertionError("bug"),
}


@pytest.mark.parametrize("kind", KINDS)
def test_classify_agrees_with_the_jax_package(kind):
    t = terrors.classify(KINDS[kind](trobust))
    j = jerrors.classify(KINDS[kind](jrobust))
    assert t == j


def test_classify_torch_cuda_oom_is_resource():
    assert terrors.classify(torch.cuda.OutOfMemoryError("CUDA out of memory")) == terrors.RESOURCE
    # by type, whatever the message says
    assert terrors.classify(torch.cuda.OutOfMemoryError("x")) == terrors.RESOURCE


@pytest.mark.parametrize("pkg", ROBUST)
def test_simulated_oom_is_resource(pkg):
    e = ROBUST[pkg].simulated_oom("store.expand")
    assert ERRORS[pkg].classify(e) == ERRORS[pkg].RESOURCE
    assert "RESOURCE_EXHAUSTED" in str(e)


def test_port_simulated_oom_is_the_cuda_oom_type():
    assert isinstance(trobust.simulated_oom("store.hbm"), torch.cuda.OutOfMemoryError)


# ---------------------------------------------------------------------------
# fault injection: the same decisions in both packages
# ---------------------------------------------------------------------------


def _fired(f, site, n, **rule):
    out = []
    with f.inject(site, RuntimeError, **rule):
        for _ in range(n):
            try:
                f.fault_point(site)
                out.append(0)
            except RuntimeError:
                out.append(1)
    return out


@pytest.mark.parametrize("rule", [
    {"every": 1}, {"every": 3}, {"after": 4}, {"every": 2, "times": 3},
    {"prob": 0.3, "seed": 11}, {"prob": 0.05, "seed": 12345}, {"after": 0, "times": 2},
])
def test_inject_rules_fire_at_the_same_hits(rule):
    t = _fired(tfaults, "store.ship", 40, **rule)
    j = _fired(jfaults, "store.ship", 40, **rule)
    assert t == j and sum(t) > 0


def _schedule(f, spec, sites, n=200):
    f.install(spec)
    out = {}
    try:
        for site in sites:
            seq = []
            for _ in range(n):
                try:
                    f.fault_point(site)
                    seq.append(0)
                except Exception:
                    seq.append(1)
            out[site] = seq
    finally:
        f.clear()
    return out


@pytest.mark.parametrize("spec", [
    "s1:0.5:store.ship+ops.dispatch",
    "chaos:0.3:store.expand+query.exec+pack_cache.budget",
    "abc:0.1:store.hbm",
    "ci-chaos-seed:0.02",
])
def test_schedule_spec_fires_at_the_same_hits(spec):
    parts = spec.split(":")
    sites = parts[2].split("+") if len(parts) > 2 else list(tfaults.SITES)
    t = _schedule(tfaults, spec, sites)
    j = _schedule(jfaults, spec, sites)
    assert t == j
    assert _schedule(tfaults, spec, sites) == t  # replay is deterministic


def test_schedule_error_kinds_match_the_site():
    rules = {r.site: r for r in tfaults.schedule_rules("x:1")}
    assert set(rules) == set(tfaults.SITES)
    assert rules["store.hbm"].exc is trobust.simulated_oom
    assert rules["pack_cache.budget"].exc is trobust.ResourceExhausted
    assert rules["store.ship"].exc is trobust.TransientDeviceError


def test_port_sites_are_a_subset_of_the_jax_sites():
    # since the write path and the durable tier, the subset is the whole
    # set: the port has every JAX site, in the JAX package's order
    assert set(tfaults.SITES) <= set(jfaults.SITES)
    assert tuple(tfaults.SITES) == tuple(jfaults.SITES)
    assert {"epoch.flip", "serve.maintain", "durable.persist"} <= set(tfaults.SITES)


def test_unknown_site_and_bad_rules_are_loud():
    with pytest.raises(ValueError):
        tfaults.inject("no.such.site", every=1)
    with pytest.raises(ValueError):
        tfaults.inject("store.ship", every=1, prob=0.5)
    with pytest.raises(ValueError):
        tfaults.inject("store.ship", prob=1.5)


def test_suspended_masks_faults_without_advancing_hits():
    with tfaults.inject("store.ship", every=1):
        with tfaults.suspended():
            tfaults.fault_point("store.ship")
        assert tfaults.site_hits().get("store.ship", 0) == 0
        with pytest.raises(trobust.TransientDeviceError):
            tfaults.fault_point("store.ship")
    assert not tfaults.active()


def test_env_schedule_install(monkeypatch):
    monkeypatch.setenv("RB_TPU_FAULTS", "test-seed:0.5:ops.dispatch")
    assert tfaults.install_env_schedule()
    hits = 0
    for _ in range(30):
        try:
            tfaults.fault_point("ops.dispatch")
        except trobust.TransientDeviceError:
            hits += 1
        tfaults.fault_point("store.ship")  # unlisted: never fires
    assert hits > 0


# ---------------------------------------------------------------------------
# retry jitter, breaker transitions, deadlines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("site", ["store.ship", "store.expand", "agg"])
def test_jitter_equals_the_jax_package(site):
    for attempt in range(1, 9):
        for base, cap in ((0.01, 0.25), (0.001, 1.0)):
            t = tladder._jitter(site, attempt, base, cap)
            assert t == jladder._jitter(site, attempt, base, cap)
            exp = min(cap, base * (1 << (attempt - 1)))
            assert exp / 2 <= t <= exp


SEQUENCES = {
    "trip-and-recover": ["f", "f", "f", "t+10", "s", "s"],
    "probe-fails": ["f", "f", "f", "t+10", "f", "t+1", "s", "t+10", "s"],
    "flapping": ["f", "s", "f", "f", "s", "f", "f", "f", "s"],
    "cooldown-not-elapsed": ["f", "f", "f", "t+1", "s", "t+5", "f", "t+10", "s"],
}


def _breaker_run(lad_mod, seq):
    """Drive one breaker through allow/success/failure on a fake clock:
    the admissions and transitions it produces."""
    b = lad_mod.Breaker(trip_after=3, cooldown_s=5.0)
    now, out = 0.0, []
    for step in seq:
        if step.startswith("t+"):
            now += float(step[2:])
            continue
        admit, trans = b.allow(now)
        out.append(("allow", admit, trans))
        if admit:
            out.append((step, b.success() if step == "s" else b.failure(now)))
        out.append(("state", b.state))
    return out


@pytest.mark.parametrize("name", SEQUENCES)
def test_breaker_transitions_equal_the_jax_package(name):
    assert _breaker_run(tladder, SEQUENCES[name]) == _breaker_run(jladder, SEQUENCES[name])


@pytest.mark.parametrize("pkg", LADDER)
def test_cpu_chain_degrades_and_fatal_propagates(pkg):
    lad, r, o = LADDER[pkg], ROBUST[pkg], {"port": tobs, "jax": jobs}[pkg]

    def bad():
        raise r.TransientDeviceError("x")

    key = ("t.site", "columnar-cpu", "per-container")
    before = _series(o, o.DEGRADE_TOTAL).get(key, 0)
    assert lad.LADDER.run("t.site", [("columnar-cpu", bad), ("per-container", lambda: 41)]) == 41
    assert _series(o, o.DEGRADE_TOTAL).get(key, 0) == before + 1

    def buggy():
        raise ValueError("a real bug")

    with pytest.raises(ValueError):
        lad.LADDER.run("t.site", [("columnar-cpu", buggy), ("per-container", lambda: 1)])
    assert lad.LADDER.breaker_state("t.site", "columnar-cpu") == "closed"
    with pytest.raises(r.TransientDeviceError):
        lad.LADDER.run("t.site", [("pure-python", bad)])


def test_the_device_tier_must_be_last():
    with pytest.raises(ValueError):
        tladder.LADDER.run("agg", [("device", lambda: 1), ("per-container", lambda: 2)])
    assert tladder.LADDER.run("agg", [("device", lambda: 3)]) == 3


def test_breaker_trips_skips_and_recovers():
    tladder.LADDER.configure(trip_after=3, cooldown_s=0.05)
    attempts = []

    def bad():
        attempts.append(1)
        raise trobust.TransientDeviceError("x")

    for _ in range(5):
        tladder.LADDER.run("t.cpu", [("columnar-cpu", bad), ("per-container", lambda: 0)])
    assert len(attempts) == 3 and tladder.LADDER.breaker_state("t.cpu", "columnar-cpu") == "open"
    assert "t.cpu/columnar-cpu" in tladder.LADDER.open_ages()
    time.sleep(0.06)
    tladder.LADDER.run("t.cpu", [("columnar-cpu", lambda: 7), ("per-container", lambda: 0)])
    assert tladder.LADDER.breaker_state("t.cpu", "columnar-cpu") == "closed"
    tr = _series(tobs, tobs.BREAKER_TRANSITIONS_TOTAL)
    for state in ("open", "half_open", "closed"):
        assert tr.get(("t.cpu", "columnar-cpu", state), 0) >= 1


def test_breaker_thread_hammer():
    """More threads than cores drive a flapping CPU tier through a ladder,
    with a short switch interval: no exception escapes, every call answers
    from one of the tiers, and the breaker stays in a valid state."""
    lad = tladder.Ladder(trip_after=3, cooldown_s=0.002)
    stop = time.monotonic() + 1.0
    escaped, wrong = [], []
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def worker(i):
        flip = 0
        while time.monotonic() < stop:
            flip += 1

            def tier(flip=flip):
                if flip % 3 == 0:
                    raise trobust.TransientDeviceError("flap")
                return flip

            try:
                got = lad.run("t.hammer", [("columnar-cpu", tier), ("per-container", lambda: -1)])
            except Exception as e:  # nothing may escape: collected to assert so
                escaped.append(e)
                continue
            if got not in (flip, -1):
                wrong.append(got)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert not escaped and not wrong
    assert lad.breaker_state("t.hammer", "columnar-cpu") in ("closed", "open", "half_open")


def test_retry_recovers_counts_and_respects_the_deadline():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise trobust.TransientDeviceError("blip")
        return "ok"

    before = _series(tobs, tobs.RETRY_TOTAL).get(("t.retry", "recovered"), 0)
    assert tladder.retry("t.retry", flaky, base_s=0.001) == "ok"
    assert _series(tobs, tobs.RETRY_TOTAL).get(("t.retry", "recovered"), 0) == before + 1
    with pytest.raises(trobust.ResourceExhausted):  # not retryable
        tladder.retry("t.retry", lambda: (_ for _ in ()).throw(trobust.ResourceExhausted("x")))

    def always():
        raise trobust.TransientDeviceError("x")

    with tladder.deadline_scope(0.0005):
        t0 = time.monotonic()
        with pytest.raises(trobust.TransientDeviceError):
            tladder.retry("t.retry", always, base_s=1.0, cap_s=1.0)
        assert time.monotonic() - t0 < 0.5  # raised instead of sleeping the budget away


@pytest.mark.parametrize("pkg", LADDER)
def test_deadline_scopes_nest_tighter(pkg):
    lad = LADDER[pkg]
    with lad.deadline_scope(60.0):
        outer = lad.deadline_remaining()
        with lad.deadline_scope(0.001):
            inner = lad.deadline_remaining()
            assert inner < outer
            with lad.deadline_scope(None):  # inherits, never widens
                assert lad.deadline_remaining() <= inner
        with lad.deadline_scope(120.0):  # never widens the outer budget
            assert lad.deadline_remaining() <= outer
        assert lad.deadline_remaining() > 1.0
    assert lad.deadline_remaining() is None and not lad.deadline_expired()


def test_deadline_routes_steps_to_the_cpu_and_counts():
    tb, _ = _both(seed=31)
    expr = tq.Q.or_(tq.Q.and_(tb[0], tb[1]), tq.Q.xor(tb[2], tb[3]))
    want = tq.evaluate_naive(expr)
    key = ("query.exec", "degraded")
    before = _series(tobs, tobs.DEADLINE_TOTAL).get(key, 0)
    assert tq.execute(expr, cache=None, mode="device", deadline_s=0.0) == want
    assert _series(tobs, tobs.DEADLINE_TOTAL).get(key, 0) == before + 1
    assert tq.execute(expr, cache=None, mode="device", deadline_s=60.0) == want
    assert _series(tobs, tobs.DEADLINE_TOTAL).get(("query.exec", "met"), 0) >= 1


# ---------------------------------------------------------------------------
# every site through its real call path, and the departures
# ---------------------------------------------------------------------------


def _q1_shape(Q, bms):
    return Q.andnot(Q.and_(Q.or_(*bms[:2]), Q.or_(*bms[2:4])), bms[4])


@pytest.mark.parametrize("site", tfaults.SITES)
def test_every_site_fires_through_its_real_path(site):
    tb, _ = _both(n=5, seed=41)
    want = TFA.or_(*tb, mode="cpu")
    exc = trobust.ResourceExhausted if site == "pack_cache.budget" else trobust.TransientDeviceError
    if site == "ops.dispatch":
        TFA.or_(*tb, mode="device")  # resident: the next call's first dispatch is the reduce
    if site == "query.fusion":
        qs = [_q1_shape(tq.Q, tb), tq.Q.or_(*tb[:3])]
    if site.startswith("columnar.") or site == "native.entry":
        want_pair = TRB.or_(tb[0], tb[1])
    with tfaults.inject(site, exc, every=1, times=1) as inj:
        if site == "query.exec":
            with pytest.raises(trobust.TransientDeviceError):
                tq.execute(_q1_shape(tq.Q, tb), cache=None, mode="device")
        elif site == "ops.dispatch":
            with pytest.raises(trobust.TransientDeviceError):
                TFA.or_(*tb, mode="device")
        elif site == "query.fusion":  # no per-query degrade: it raises
            with pytest.raises(trobust.TransientDeviceError):
                tq.execute_fused(qs, cache=None, mode="device")
        elif site in ("columnar.kernel", "native.entry"):  # no numpy degrade
            with pytest.raises(trobust.TransientDeviceError) as ei:
                tcolumnar.pairwise("or", tb[0], tb[1], tier="cpu")
            assert trobust.classify(ei.value) == terrors.TRANSIENT
        elif site == "columnar.device":  # retried on the device
            assert tcolumnar.pairwise("or", tb[0], tb[1], tier="device") == want_pair
        elif site == "query.hedge":  # the solo rung degrades to the window
            with tq.FusionExecutor(max_wait_ms=20.0, cache=None, mode="device") as ex:
                got = ex.submit(tq.Q.or_(*tb), slack_ms=0.001,
                                latency_class="interactive").result(timeout=60)
                assert ex.hedges == 1 and ex.batches == 1
            assert got == want
        elif site == "serve.admit":  # fails open: a quota that sheds admits
            from roaringbitmap_tpu_torch.serve import AdmissionController, slo

            slo.TENANTS.declare("site-t", quota_qps=0.5, burst=1.0)
            try:
                c = AdmissionController(max_inflight=4, queue_limit=0)
                with tfaults.suspended():
                    c.admit("site-t", now=0.0).release()  # spends the one token
                    assert not c.admit("site-t", now=0.0).admitted
                tk = c.admit("site-t", now=0.0)
                assert tk.admitted and tk.degraded
                tk.release()
            finally:
                slo.reset()
        elif site in ("epoch.flip", "serve.maintain", "durable.persist"):
            # fail closed to the old epoch / the uncompacted corpus / memory only
            import tempfile

            from roaringbitmap_tpu_torch import durable
            from roaringbitmap_tpu_torch.observe import structure
            from roaringbitmap_tpu_torch.serve import EpochStore, maintain, slo

            slo.TENANTS.declare("site-t", quota_qps=1e6, burst=1e6)
            try:
                es = EpochStore(tb)
                es.submit("site-t", {0: [123]})
                if site == "epoch.flip":
                    assert es.flip()["outcome"] == "aborted"
                    assert es.current() == 0 and not tb[0].contains(123)
                elif site == "serve.maintain":
                    structure.LEDGER.watch("site", tb)
                    assert maintain.run_pass(es, force=True)["outcome"] == "aborted"
                    assert es.current() == 0 and es.log.depth() == 1
                else:
                    with tempfile.TemporaryDirectory() as root:
                        ds = durable.DurableStore(root)
                        assert ds.persist(es)["outcome"] == "aborted"
                        assert durable.recover(root) is None
            finally:
                structure.LEDGER.reset()
                maintain.reset()
                slo.reset()
        else:  # ship, hbm, expand: retried on the device; budget: spilled
            assert TFA.or_(*tb, mode="device") == want
    assert inj.fired == 1
    assert insights.robust_counters()["faults"].get(site, 0) >= 1


def test_transient_ship_fault_is_retried_recovered_and_exact():
    tb, jb = _both(seed=13)
    key = ("store.ship", "recovered")
    before = _series(tobs, tobs.RETRY_TOTAL).get(key, 0)
    with tfaults.inject("store.ship", trobust.TransientDeviceError, every=1, times=1) as ti:
        got = TFA.or_(*tb, mode="device")
    with jfaults.inject("store.ship", jrobust.TransientDeviceError, every=1, times=1):
        want = JFA.or_(*jb, mode="device")
    assert ti.fired == 1
    assert got.serialize() == want.serialize()
    assert _series(tobs, tobs.RETRY_TOTAL).get(key, 0) == before + 1
    assert tladder.LADDER.breaker_state("agg", "device") == "closed"


def test_oom_at_expand_raises_in_the_port_and_degrades_in_jax():
    tb, jb = _both(seed=11)
    with tfaults.inject("store.expand", trobust.simulated_oom, every=1):
        with pytest.raises(torch.cuda.OutOfMemoryError) as ei:
            TFA.or_(*tb, mode="device")
    assert terrors.classify(ei.value) == terrors.RESOURCE
    assert _series(tobs, tobs.RETRY_TOTAL).get(("store.expand", "not_retryable"), 0) >= 1
    with jfaults.inject("store.expand", jrobust.simulated_oom, every=1):
        jgot = JFA.or_(*jb, mode="device")
    assert jgot.serialize() == JFA.naive_or(*jb).serialize()


def test_dispatch_fault_raises_in_the_port_and_degrades_in_jax():
    tb, jb = _both(seed=23)
    TFA.or_(*tb, mode="device")  # resident: the faults hit the reduce, not the expansion
    before = _series(tobs, tobs.BREAKER_TRANSITIONS_TOTAL)
    with tfaults.inject("ops.dispatch", trobust.TransientDeviceError, every=1):
        for _ in range(3):
            with pytest.raises(trobust.TransientDeviceError) as ei:
                TFA.or_(*tb, mode="device")
            assert terrors.classify(ei.value) == terrors.TRANSIENT
    # the device tier is the bottom rung: its breaker opens and it is still tried
    assert tladder.LADDER.breaker_state("agg", "device") == "open"
    assert _series(tobs, tobs.BREAKER_TRANSITIONS_TOTAL).get(("agg", "device", "open"), 0) == (
        before.get(("agg", "device", "open"), 0) + 1
    )
    assert not any(k[0] == "agg" for k in _series(tobs, tobs.DEGRADE_TOTAL))
    with jfaults.inject("ops.dispatch", jrobust.TransientDeviceError, every=1):
        jgot = JFA.or_(*jb, mode="device")
    assert jgot.serialize() == TFA.or_(*tb, mode="cpu").serialize()


def test_pack_cache_pressure_spills_and_stays_on_the_device():
    tb, _ = _both(seed=17)
    with tfaults.inject("pack_cache.budget", trobust.ResourceExhausted, every=1) as inj:
        packed = store.packed_for(tb, device="cpu")
    assert inj.fired == 1 and len(store.PACK_CACHE) == 0  # served uncached
    fresh = store.pack_groups(store.group_by_key(tb), "cpu")
    assert torch.equal(packed.device_words, fresh.device_words)
    assert insights.robust_counters()["degrade"].get("pack_cache.budget/resident/uncached", 0) >= 1
    from roaringbitmap_tpu_torch.observe import decisions as tdec

    assert tdec.decisions(1)[0]["decision"] == "spill-and-serve-uncached"
    packed2 = store.packed_for(tb, device="cpu")
    assert len(store.PACK_CACHE) == 1 and store.packed_for(tb, device="cpu") is packed2


def test_cuda_without_a_card_still_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card path cannot be shown here")
    monkeypatch.setattr(aggregation.config, "device", "cuda")
    tb, _ = _both(seed=3)
    with pytest.raises(trobust.TierUnavailable):
        TFA.or_(*tb, mode="device")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_transient_ship_fault_recovers_and_oom_raises(monkeypatch):
    """On the card: a transient ``store.ship`` fault is retried and the OR
    equals the CPU fold; a simulated OOM at ``store.expand`` raises and no
    answer is returned. Skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    monkeypatch.setattr(aggregation.config, "device", "cuda")
    tb, _ = _both(seed=43)
    want = TFA.or_(*tb, mode="cpu")
    with tfaults.inject("store.ship", trobust.TransientDeviceError, every=1, times=1) as inj:
        assert TFA.or_(*tb, mode="device") == want
    assert inj.fired == 1
    store.PACK_CACHE.close()
    with tfaults.inject("store.expand", trobust.simulated_oom, every=1):
        with pytest.raises(torch.cuda.OutOfMemoryError):
            TFA.or_(*tb, mode="device")


@pytest.mark.cuda
def test_cuda_real_oom_classifies_resource():
    """A real allocation past the card's memory raises
    ``torch.cuda.OutOfMemoryError``, which ``classify`` calls resource."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    total = torch.cuda.get_device_properties(0).total_memory
    with pytest.raises(torch.cuda.OutOfMemoryError) as ei:
        torch.empty(total * 2, dtype=torch.uint8, device="cuda")
    assert terrors.classify(ei.value) == terrors.RESOURCE
