"""The port's static analyzer (``roaringbitmap_tpu_torch.analysis``) against
the JAX package's.

Every source snippet of ``tests/test_analysis.py`` gives the same
``(rule, line)`` findings through both analyzers for each ported lexical
rule, and the contract fixtures give the same findings for each ported
contract rule (the documents a rule reads are the port's own: the
package's ``KNOBS.md`` and its README section). Where the port's idioms
differ — a ``_guarded(site, fn)`` wrapper, authorities built as
``ModelAuthority("name", model)`` instances, two ``_drop`` methods in one
module, the ``fuzz.RAISING_SITES`` table of sites that raise — the rule
learned the idiom, and the tests below show both what the port's rule
sees and that the JAX rule, on the same text, still reads what it read.
Over ``roaringbitmap_tpu_torch`` both tiers read 0 findings with an empty
baseline, and the extracted registries equal the JAX package's less the
listed departures.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import pytest

from roaringbitmap_tpu.analysis import get_project as jget_project
from roaringbitmap_tpu.analysis import run_checks as jrun_checks
from roaringbitmap_tpu.analysis import run_contract_checks as jrun_contract_checks
from roaringbitmap_tpu.analysis.project import ProjectContext as JProjectContext
from roaringbitmap_tpu.observe import export as jexport

from roaringbitmap_tpu_torch import analysis
from roaringbitmap_tpu_torch import observe as tobs
from roaringbitmap_tpu_torch.analysis import baseline, knobs
from roaringbitmap_tpu_torch.analysis.lockwitness import LockWitness
from roaringbitmap_tpu_torch.analysis.project import ProjectContext
from roaringbitmap_tpu_torch.observe import export as texport
from roaringbitmap_tpu_torch.observe import timeline as ttl

REPO = pathlib.Path(__file__).resolve().parent.parent
LEXICAL = ["dtype-discipline", "exception-hygiene", "lock-discipline", "metric-naming"]
CONTRACT = ["authority-surface", "decision-discipline", "epoch-pin", "fault-site-contract",
            "knob-doc", "metric-discipline", "sentinel-table-drift"]


def test_rule_sets_are_the_jax_sets_less_the_two_jit_rules():
    from roaringbitmap_tpu.analysis import all_contract_rule_ids as jc
    from roaringbitmap_tpu.analysis import all_rule_ids as jl

    assert analysis.all_rule_ids() == LEXICAL == sorted(set(jl()) - {"trace-safety"})
    assert analysis.all_contract_rule_ids() == CONTRACT == sorted(set(jc()) - {"use-after-donation"})
    from roaringbitmap_tpu import analysis as janalysis

    assert set(analysis.__all__) == set(janalysis.__all__)


# ---------------------------------------------------------------------------
# lexical parity: every snippet of the JAX analysis tests
# ---------------------------------------------------------------------------


def _snippets():
    """Every multi-line string literal of tests/test_analysis.py that
    parses as Python, plus the may-hold fixtures it builds by
    concatenation."""
    tree = ast.parse((REPO / "tests" / "test_analysis.py").read_text())
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and "\n" in node.value:
            try:
                ast.parse(node.value)
            except SyntaxError:
                continue
            if node.value.strip():
                out.setdefault(node.value, f"line{node.lineno}")
    mayhold = next(s for s in out if "def _bump" in s)
    for extra in ("\ndef sneaky(k):\n    _bump(k)\n", "\nCALLBACK = _bump\n",
                  "\ndef _middle(k):\n    _bump(k)\n\ndef outer(k):\n    with _L:\n        _middle(k)\n"):
        out.setdefault(mayhold + extra, f"mayhold{len(out)}")
    return {name: src for src, name in out.items()}


SNIPPETS = _snippets()


def _lexical(run, tmp_path, src):
    path = tmp_path / "snippet.py"
    path.write_text(src)
    res = run([str(path)], rules=LEXICAL, root=str(tmp_path))
    return sorted((f.rule, f.line) for f in res.findings), res.suppressed


def test_the_snippets_cover_every_lexical_rule(tmp_path):
    assert len(SNIPPETS) >= 30
    fired = set()
    for src in SNIPPETS.values():
        fired |= {rule for rule, _ in _lexical(analysis.run_checks, tmp_path, src)[0]}
    assert fired == set(LEXICAL)


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_lexical_findings_are_the_jax_findings(name, tmp_path):
    src = SNIPPETS[name]
    assert _lexical(analysis.run_checks, tmp_path, src) == _lexical(jrun_checks, tmp_path, src)


TWO_DROPS = """\
import threading

class Packed:
    def __init__(self):
        self._lock = threading.Lock()
        self._rows = {}  # guarded-by: self._lock

    def _drop(self):
        with self._lock:
            self._rows.clear()

class Cache:
    def __init__(self):
        self._lock = threading.Lock()
        self._entries = {}  # guarded-by: self._lock

    def _drop(self, key):
        self._entries.pop(key)

    def discard(self, key):
        with self._lock:
            self._drop(key)
"""


def test_lock_rule_resolves_a_method_within_its_class(tmp_path):
    """Two classes of one module with a ``_drop`` each (the port's
    ``PackedGroups`` and ``PackCache``): the port resolves ``self._drop``
    to the caller's class, so the locked caller clears the helper; the
    JAX rule gives up on the duplicated name and flags the write."""
    port, _ = _lexical(analysis.run_checks, tmp_path, TWO_DROPS)
    jax, _ = _lexical(jrun_checks, tmp_path, TWO_DROPS)
    assert port == [] and jax == [("lock-discipline", 18)]
    unlocked = TWO_DROPS + "\n    def sneaky(self, key):\n        self._drop(key)\n"
    assert _lexical(analysis.run_checks, tmp_path, unlocked)[0] == [("lock-discipline", 18)]
    escaped = TWO_DROPS + "\n    def hook(self):\n        return self._drop\n"
    assert _lexical(analysis.run_checks, tmp_path, escaped)[0] == [("lock-discipline", 18)]


# ---------------------------------------------------------------------------
# contract parity: the JAX contract fixtures
# ---------------------------------------------------------------------------


def _tree(root, files, root_files=None):
    for rel, src in files.items():
        p = root / "pkg" / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
    for rel, src in (root_files or {}).items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)


def _both(tmp_path, files, rule, root_files=None, port_docs=None):
    """(port findings, JAX findings) as (basename, line) lists over one
    synthetic package ``pkg``; ``root_files`` are the JAX documents and
    ``port_docs`` the port's."""
    jroot, troot = tmp_path / "jax", tmp_path / "port"
    _tree(jroot, files, root_files)
    _tree(troot, files, port_docs)

    def key(res):
        return sorted((os.path.basename(f.path), f.line) for f in res.findings)

    port = analysis.run_contract_checks(ProjectContext(str(troot), package="pkg"), rules=[rule])
    jax = jrun_contract_checks(JProjectContext(str(jroot), package="pkg"), rules=[rule])
    return key(port), key(jax), port, jax


_FAULT_FILES = {
    "robust/faults.py": 'SITES = (\n    "a.ok",\n    "a.bad",\n)\n',
    "mod.py": (
        "def f():\n"
        '    fault_point("a.ok")\n'
        '    LADDER.run("a.ok", None)\n'
        "def g():\n"
        '    fault_point("a.rogue")\n'
    ),
    "fuzz.py": '_EXERCISED = "a.ok"\n',
}
_DECISION_SRC = """\
def discarded():
    record_decision("s.a", {}, outcome=True)

def dropped():
    seq = record_decision("s.b", {}, outcome=True)
    return 1

def joined(t):
    seq = record_decision("s.c", {}, outcome=True)
    resolve(seq, "s.c", t)

def threaded():
    return record_decision("s.d", {}, outcome=True)

def fire_and_forget():
    record_decision("s.e", {})

def dynamic(flag):
    record_decision("s.f", {}, outcome=flag)
"""
_EPOCH_SRC = SNIPPETS[next(n for n, s in SNIPPETS.items() if "def conditional(store" in s)]
_AUTH_FACADE = (
    '"""Authorities:\n\n| authority | role |\n|-----------|------|\n| alpha     | x    |\n"""\n'
    "class Authority:\n"
    '    name = ""\n'
    "class AlphaAuthority(Authority):\n"
    '    name = "alpha"\n'
    "    def curves(self):\n        pass\n"
    "    def provenance(self):\n        pass\n"
    "    def refit_from_outcomes(self):\n        pass\n"
    "    def state(self):\n        pass\n"
    "    def load_state(self, s):\n        pass\n"
    "    def reset(self):\n        pass\n"
    "class BetaAuthority(Authority):\n"
    '    name = "beta"\n'
    "    def curves(self):\n        pass\n"
    'AUTHORITIES = {"alpha": AlphaAuthority(), "beta": BetaAuthority()}\n'
)
_PORT_README = "# r\n\n## Elsewhere\n\nthe beta authority\n\n## The port (`pkg/`)\n\nthe alpha authority\n"

CONTRACT_CASES = {
    "fault-seeded": ("fault-site-contract", _FAULT_FILES, None, None),
    "fault-waiver": ("fault-site-contract", dict(_FAULT_FILES, **{
        "robust/faults.py": 'SITES = (\n    "a.ok",\n    "a.bad",  # rb-ok: fault-site-contract -- rides a.ok\n)\n',
        "mod.py": _FAULT_FILES["mod.py"].replace('fault_point("a.rogue")', 'fault_point("a.ok")')}),
        None, None),
    "fault-empty": ("fault-site-contract", {"robust/faults.py": "SITES = ()\nX = 1\n"}, None, None),
    "decision-seeded": ("decision-discipline", {"mod.py": _DECISION_SRC}, None, None),
    "decision-pragma": ("decision-discipline", {"mod.py": (
        "def fire():\n"
        '    record_decision("s.a", {}, outcome=True)'
        "  # rb-ok: decision-discipline -- probe decision, join not wanted\n")}, None, None),
    "epoch-seeded": ("epoch-pin", {"serve/h.py": _EPOCH_SRC}, None, None),
    "epoch-non-serve": ("epoch-pin", {"ops/h.py": _EPOCH_SRC}, None, None),
    "metric-seeded": ("metric-discipline", {
        "observe/registry.py": (
            'GOOD_TOTAL = "rb_tpu_good_total"\n'
            'DEAD_TOTAL = "rb_tpu_dead_total"\n'
            "def counter(name, help, labels=()):\n    pass\n"),
        "obs_use.py": (
            "from .observe import registry\n"
            'C = registry.counter(registry.GOOD_TOTAL, "h", ("op",))\n'
            'D = registry.counter("rb_tpu_inline_total", "h")\n'
            'E = registry.counter(registry.GOOD_TOTAL, "h", ("kind",))\n')}, None, None),
    "sentinel-seeded": ("sentinel-table-drift", {"observe/health.py": (
        '"""Rules:\n\nalpha-drift      geomean over window\nbeta-stall       p99 over budget\n"""\n'
        "class Rule:\n    def __init__(self, name, x):\n        pass\n"
        "DEFAULT_RULES = (\n"
        '    Rule("alpha-drift", 1),\n'
        '    Rule("gamma-new", 2),\n'
        ")\n")}, None, None),
    "authority-seeded": ("authority-surface", {"cost/facade.py": _AUTH_FACADE},
                         {"ARCHITECTURE.md": "the alpha authority\n"}, {"README.md": _PORT_README}),
    "knob-undocumented": ("knob-doc", {"mod.py": 'import os\nV = os.environ.get("RB_TPU_X", "1")\n'},
                          None, None),
    "knob-stale": ("knob-doc", {"mod.py": 'import os\nV = os.environ.get("RB_TPU_X", "1")\n'},
                   {"KNOBS.md": "| `RB_TPU_X` | 1 | m | d |\n| `RB_TPU_GONE` | - | m | d |\n"},
                   {"pkg/KNOBS.md": "| `RB_TPU_X` | 1 | m | d |\n| `RB_TPU_GONE` | - | m | d |\n"}),
}


@pytest.mark.parametrize("case", sorted(CONTRACT_CASES))
def test_contract_findings_are_the_jax_findings(case, tmp_path):
    rule, files, jax_docs, port_docs = CONTRACT_CASES[case]
    port, jax, pres, jres = _both(tmp_path, files, rule, jax_docs, port_docs)
    assert port == jax
    assert pres.suppressed == jres.suppressed
    assert [f.rule for f in pres.findings] == [rule] * len(port)


def test_the_contract_cases_find_something_for_every_rule(tmp_path):
    fired = set()
    for i, (rule, files, jax_docs, port_docs) in enumerate(CONTRACT_CASES.values()):
        port, _, _, _ = _both(tmp_path / str(i), files, rule, jax_docs, port_docs)
        if port:
            fired.add(rule)
    assert fired == set(CONTRACT)


# ---------------------------------------------------------------------------
# the port's idioms, learned by the rules
# ---------------------------------------------------------------------------

_GUARDED_FILES = {
    "robust/faults.py": 'SITES = (\n    "s.ship",\n    "s.expand",\n)\n',
    "store.py": (
        "def _guarded(site, fn):\n"
        "    def _attempt():\n"
        "        fault_point(site)\n"
        "        return fn()\n"
        "    return ladder.retry(site, _attempt)\n"
        "def ship(x):\n"
        '    return _guarded("s.ship", lambda: x)\n'
        "def expand(x):\n"
        '    return _guarded("s.expand", lambda: x)\n'
    ),
    "fuzz.py": 'SITES_SEEN = ("s.ship", "s.expand")\n',
}


def test_fault_contract_sees_a_guarded_wrapper(tmp_path):
    port, jax, _, _ = _both(tmp_path, _GUARDED_FILES, "fault-site-contract")
    assert port == []
    # the JAX rule on the same text: no literal guard, no literal route
    assert jax == [("faults.py", 2)] * 2 + [("faults.py", 3)] * 2
    project = ProjectContext(str(tmp_path / "port"), package="pkg")
    assert [ln for _p, ln in project.fault_guards["s.ship"]] == [7]
    assert [ln for _p, ln in project.ladder_routes["s.expand"]] == [9]


def test_fault_contract_accepts_no_route_only_for_the_raising_table(tmp_path):
    files = {
        "robust/faults.py": 'SITES = (\n    "a.raise",\n)\n',
        "mod.py": 'def f():\n    fault_point("a.raise")\n',
        "fuzz.py": 'RAISING_SITES = (\n    "a.raise",\n)\n',
    }
    port, jax, _, _ = _both(tmp_path, files, "fault-site-contract")
    assert port == [] and jax == [("faults.py", 2)]
    files["fuzz.py"] = 'RAISING_SITES = ()\nSEEN = "a.raise"\n'
    port, _, res, _ = _both(tmp_path / "b", files, "fault-site-contract")
    assert port == [("faults.py", 2)]
    assert "fuzz.RAISING_SITES" in res.findings[0].message


def test_fault_contract_sees_store_ship_and_expand_guarded_in_the_port():
    project = analysis.get_project(str(REPO))
    store = project.pkg_path("parallel", "store.py")
    for site in ("store.ship", "store.expand"):
        assert any(p == store for p, _ in project.fault_guards[site]), site
        assert any(p == store for p, _ in project.ladder_routes[site]), site
    from roaringbitmap_tpu_torch import fuzz

    assert set(project.raising_sites) == set(fuzz.RAISING_SITES)


def test_authority_surface_sees_instances_and_deeper_subclasses(tmp_path):
    facade = (
        '"""| authority |\n| alpha |\n| beta |\n| gamma |\n"""\n'
        "class Authority:\n"
        '    name = "?"\n'
        "class Model(Authority):\n"
        "    def __init__(self, name, model):\n"
        "        self.name = name\n"
        "    def curves(self):\n        pass\n"
        "    def provenance(self):\n        pass\n"
        "    def refit_from_outcomes(self):\n        pass\n"
        "    def state(self):\n        pass\n"
        "    def load_state(self, s):\n        pass\n"
        "    def reset(self):\n        pass\n"
        "class Gamma(Model):\n"
        "    def __init__(self):\n"
        '        super().__init__("gamma", None)\n'
        "class Broken(Authority):\n"
        "    def __init__(self, name):\n"
        "        self.name = name\n"
        "AUTHORITIES = {a.name: a for a in (\n"
        '    Model("alpha", 1),\n'
        '    Model("beta", 2),\n'
        "    Gamma(),\n"
        '    Broken("delta"),\n'
        ")}\n"
    )
    docs = {"README.md": "## The port (`pkg/`)\n\nalpha beta gamma\n"}
    port, jax, res, _ = _both(tmp_path, {"cost/facade.py": facade}, "authority-surface",
                              {"ARCHITECTURE.md": "alpha beta gamma\n"}, docs)
    project = ProjectContext(str(tmp_path / "port"), package="pkg")
    assert sorted(a.name for a in project.authorities) == ["alpha", "beta", "delta", "gamma"]
    # delta inherits the raising base's protocol and is in no document
    delta = facade.splitlines().index('    Broken("delta"),') + 1
    assert port == [("facade.py", delta)] * 3 and all("delta" in f.message for f in res.findings)
    # the JAX rule sees no authority in this text
    assert jax == [("facade.py", 1)]


def test_authority_surface_sees_the_eight_authorities_of_the_port():
    tnames = {a.name for a in analysis.get_project(str(REPO)).authorities}
    jnames = {a.name for a in jget_project(str(REPO)).authorities}
    assert tnames == jnames and len(tnames) == 8
    assert all(a.registered for a in analysis.get_project(str(REPO)).authorities)


# ---------------------------------------------------------------------------
# the trees and the registries
# ---------------------------------------------------------------------------


def test_the_port_reads_zero_findings_with_an_empty_baseline():
    project = analysis.get_project(str(REPO))
    lex = analysis.run_checks([str(REPO / "roaringbitmap_tpu_torch")], root=str(REPO))
    con = analysis.run_contract_checks(project)
    assert [f.render() for f in lex.findings + con.findings] == []
    assert not lex.parse_errors and not con.parse_errors
    assert baseline.load(baseline.DEFAULT_BASELINE_PATH) == set()
    assert json.loads(pathlib.Path(baseline.DEFAULT_BASELINE_PATH).read_text())["findings"] == []


def test_the_jax_analyzer_still_reads_zero_over_the_jax_package():
    jproject = jget_project(str(REPO))
    lex = jrun_checks([str(REPO / "roaringbitmap_tpu")], root=str(REPO))
    assert lex.findings == [] and jrun_contract_checks(jproject).findings == []


def test_registries_are_the_jax_registries_less_the_departures():
    t, j = analysis.get_project(str(REPO)), jget_project(str(REPO))
    assert list(t.fault_sites) == list(j.fault_sites) and len(t.fault_sites) == 15
    assert {d.site for d in t.decision_sites} == {d.site for d in j.decision_sites}
    assert set(t.sentinel_rules) == set(j.sentinel_rules) and len(t.sentinel_rules) == 16
    assert set(t.knobs) == set(j.knobs) - {"RB_TPU_EXPAND"} and len(t.knobs) == 29
    # the port's one metric of its own: resident BSI found sets
    assert set(t.metric_constants) == set(j.metric_constants) - {"KERNEL_PROBE_TOTAL"} | {"BSI_FOUND_TOTAL"}
    assert all(t.metric_constants[k][0] == j.metric_constants[k][0]
               for k in set(t.metric_constants) & set(j.metric_constants))


def test_knob_table_is_the_package_table():
    project = analysis.get_project(str(REPO))
    rendered = knobs.render(project)
    committed = (REPO / "roaringbitmap_tpu_torch" / knobs.KNOBS_DOC).read_text()
    assert rendered == committed
    assert knobs.documented_knobs(committed) == set(project.knobs)
    assert "RB_TPU_EXPAND" not in committed


def test_the_exercise_surface_is_the_ports_own(tmp_path):
    _tree(tmp_path, {"fuzz.py": 'A = "from.fuzz"\n'},
          {"tests/test_torch_x.py": 'B = "from.port.test"\n', "tests/test_x.py": 'C = "from.jax.test"\n'})
    text = ProjectContext(str(tmp_path), package="pkg").exercise_text()
    assert "from.fuzz" in text and "from.port.test" in text and "from.jax.test" not in text


# ---------------------------------------------------------------------------
# the CLI and the sidecar
# ---------------------------------------------------------------------------


def _cli(*args, cwd=REPO):
    return subprocess.run([sys.executable, "-m", "roaringbitmap_tpu_torch.analysis", *args],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_cli_gates_the_port():
    out = _cli("--check", "--contracts")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 finding(s)" in out.stdout and "lexical+contracts" in out.stdout
    knob = _cli("--check-knobs")
    assert knob.returncode == 0 and "29 knobs" in knob.stdout
    rules = _cli("--list-rules")
    assert rules.returncode == 0 and len(rules.stdout.splitlines()) == len(LEXICAL) + len(CONTRACT)
    assert _cli("--rules", "trace-safety").returncode == 2


def test_cli_flags_an_injected_violation(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def f():\n    try:\n        pass\n    except Exception:\n        pass\n")
    out = _cli("--check", "--json", str(bad))
    assert out.returncode == 1
    doc = json.loads(out.stdout)
    assert doc["new"] == 1 and doc["findings"][0]["rule"] == "exception-hygiene"
    assert _cli("--check", str(tmp_path / "missing.py")).returncode == 2


def test_sidecar_analysis_block_has_the_jax_shape(capsys):
    from roaringbitmap_tpu import observe as jobs
    from roaringbitmap_tpu_torch.analysis import __main__ as cli

    assert cli.main(["--contracts", "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["new"] == 0
    block = texport.sidecar_snapshot()["analysis"]
    want = jexport._analysis_block(jobs.REGISTRY.snapshot())
    assert set(block) == set(want) == {"lexical", "contracts", "total"}
    assert set(block["lexical"]) == set(LEXICAL) and set(block["contracts"]) == set(CONTRACT)
    assert all(v == 0 for v in block["lexical"].values()) and block["total"] == 0
    snap = tobs.REGISTRY.snapshot()
    assert {tobs.ANALYSIS_FINDINGS_TOTAL, tobs.ANALYSIS_CONTRACT_FINDINGS_TOTAL} <= set(snap)


# ---------------------------------------------------------------------------
# the lock witness over the port's leaf locks
# ---------------------------------------------------------------------------


def test_serve_locks_are_leaves_hammer_16_threads():
    from roaringbitmap_tpu_torch.serve import AdmissionController, slo

    slo.reset()
    slo.TENANTS.declare("hammer-t", quota_qps=1e9, burst=1e9)
    c = AdmissionController(max_inflight=64, queue_limit=8)
    w = LockWitness()
    c._cond = threading.Condition(w.wrap("serve.admission", threading.Lock()))
    slo_lock = slo.TENANTS._lock
    slo.TENANTS._lock = w.wrap("serve.slo", slo_lock)
    reg_lock = tobs.REGISTRY._lock
    tobs.REGISTRY._lock = w.wrap("registry", reg_lock)
    rec_lock = ttl.RECORDER._lock
    ttl.RECORDER._lock = w.wrap("recorder", rec_lock)
    prev_mode = ttl.mode_name()
    ttl.configure(mode="on")
    stop = time.monotonic() + 1.0
    errors = []

    def worker(i):
        k = 0
        while time.monotonic() < stop:
            k += 1
            try:
                t = c.admit("hammer-t")
                slo.record("hammer-t", "ok", queue_s=t.queue_s, execute_s=1e-5 * (i + 1))
                if k % 3 == 0:
                    c.stats()
                if k % 5 == 0:
                    slo.tenant_rows()  # concurrent reader
                t.release()
            except Exception as e:  # rb-ok: exception-hygiene -- hammer collects escapes to assert none happened
                errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        ttl.configure(mode=prev_mode)
        slo.TENANTS._lock = slo_lock
        tobs.REGISTRY._lock = reg_lock
        ttl.RECORDER._lock = rec_lock
        slo.reset()
    assert not errors
    w.assert_consistent()
    assert w.acquisitions.get("serve.admission", 0) > 0
    assert w.acquisitions.get("serve.slo", 0) > 0
    # leaf property: nothing is ever acquired while holding a serve lock
    for leaf in ("serve.admission", "serve.slo"):
        assert not [e for e in w.edges if e[0] == leaf], sorted(w.edges)
