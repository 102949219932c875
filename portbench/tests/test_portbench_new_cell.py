"""A cell joins the benchmark through new files alone: its maker's and
kind's tiny sizes are found by name, like everything else the harness
runs. A probe cell, whose maker, kind, configuration, traffic and tiny
sizes live in a temporary tree, runs through the harness's tests' own
``tiny_run`` with no table in ``helpers.py``."""

from __future__ import annotations

import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import run
from portbench.tests import helpers

PKG = Path(run.__file__).resolve().parent


def _modules(group: str) -> list:
    return sorted(p.stem for p in (PKG / group).glob("*.py") if p.stem != "__init__")


@pytest.mark.parametrize("group, name",
                         [("configs", n) for n in _modules("configs")]
                         + [("kinds", n) for n in _modules("kinds")])
def test_each_maker_and_kind_has_its_tiny_sizes(group, name):
    sizes = helpers.tiny_sizes(group, name)
    assert all(isinstance(sizes.get(s, {}), dict) for s in helpers.SECTIONS)


def test_each_tiny_file_is_a_makers_or_a_kinds():
    for group in ("configs", "kinds"):
        files = sorted(p.stem for p in (helpers.TINY / group).glob("*.json"))
        assert files == _modules(group), group


def test_a_missing_tiny_file_names_the_file_to_add(monkeypatch, tmp_path):
    monkeypatch.setattr(helpers, "TINY", tmp_path)
    want = r"maker 'runs_scatter': add .*configs/runs_scatter\.json"
    with pytest.raises(FileNotFoundError, match=want):
        helpers.tiny_parts(helpers.BENCHMARK_CELLS[0])


# ---- the probe: a maker of sorted distinct values and the port's bitmap of
# them, and a kind that asks the bitmap for the rank of a drawn value ----

class _Values:
    def __init__(self, values: np.ndarray):
        self.values = values
        self.bitmap = None

    def free_program(self) -> None:
        self.bitmap = None


def _draw(cfg, seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    drawn = torch.randint(0, int(cfg["universe"]), (int(cfg["values"]),), generator=g,
                          device=device)
    return torch.unique(drawn).cpu().numpy()


def _load(cfg, drawn, device):
    from roaringbitmap_tpu_torch import RoaringBitmap

    dep = _Values(drawn)
    dep.bitmap = RoaringBitmap(drawn.astype(np.uint32))
    return dep


def _rank(values: np.ndarray, x: int) -> int:
    return int(np.searchsorted(values, x, side="right"))


MAKER = dict(draw=_draw, load=_load)
KIND = dict(
    prepare=lambda dep, params: dep.bitmap,
    draw=lambda rng, dep, params: int(rng.integers(0, int(params["top"]))),
    call=lambda bitmap, x: bitmap.rank(x),
    expected=lambda dep, params, x: _rank(dep.values, x),
    prepare_control=lambda dep, params: dep.values[1:],  # its least value left out
    control_call=_rank,
)
PROBE_CONFIG = {"name": "probe-values", "maker": "probe_values", "values": 1_000_000,
                "universe": 1 << 20}
PROBE_MIX = {"kind": "probe_rank", "clients": 1, "warmup_per_client": 64, "keep_share": 0.1,
             "params": {"top": 1 << 20}}
TINY_MAKER = {"config": {"values": 2000}, "card_config": {"values": 50_000}}
TINY_KIND = {"mix": {"warmup_per_client": 2, "keep_share": 1.0},
             "control_config": {"values": 3000}}


def _write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj))


@pytest.fixture
def probe(monkeypatch, tmp_path):
    """The benchmark with the probe's configuration and cell added, its
    files in a checkout-shaped tree at ``tmp_path`` that the harness and the
    tiny-size reader are pointed at."""
    for name, attrs in (("configs.probe_values", MAKER), ("kinds.probe_rank", KIND)):
        mod = types.ModuleType(f"portbench.{name}")
        mod.__dict__.update(attrs)
        monkeypatch.setitem(sys.modules, mod.__name__, mod)
    _write(tmp_path / "portbench" / "configs" / "probe-values.json", PROBE_CONFIG)
    _write(tmp_path / "portbench" / "traffic" / "probe-rank.json", PROBE_MIX)
    _write(tmp_path / "tiny" / "configs" / "probe_values.json", TINY_MAKER)
    _write(tmp_path / "tiny" / "kinds" / "probe_rank.json", TINY_KIND)
    monkeypatch.setattr(run, "ROOT", tmp_path)
    monkeypatch.setattr(helpers, "TINY", tmp_path / "tiny")
    bench = helpers.bench_with_held_back()
    bench["configs"].append({"name": "probe-values", "file": "portbench/configs/probe-values.json"})
    bench["workloads"].append({"name": "probe-rank", "config": "probe-values",
                               "traffic": "probe-rank", "chips": 1})
    return bench


@pytest.mark.parametrize("control, card, values", [(False, False, 2000), (True, False, 3000),
                                                   (False, True, 50_000), (True, True, 50_000)])
def test_the_probe_takes_its_tiny_sizes_from_its_files(probe, control, card, values):
    _, cfg, mix = helpers.tiny_parts("probe-rank", control=control, card=card, bench=probe)
    assert cfg == {**PROBE_CONFIG, "values": values}
    assert mix == {**PROBE_MIX, "warmup_per_client": 2, "keep_share": 1.0}


@pytest.mark.parametrize("control", [False, True])
def test_a_cell_of_new_files_alone_runs_through_the_harness(probe, control):
    res, lines = helpers.tiny_run("probe-rank", seconds=0.5, control=control, bench=probe)
    assert res["failed"] == 0 and res["checks"]["compared_answers"]["value"] >= 1
    assert res["correct"] is not control, lines
    assert (res["checks"]["wrong_answers"]["value"] > 0) is control


def test_a_promoted_held_back_cell_counts_once(monkeypatch):
    """A later benchmark that holds a held-back cell, its configuration and
    its own metric lists: the merge adds none of them a second time."""
    bench = run.load_benchmark()
    promoted = helpers.HELD_BACK["workloads"][0]
    bench["configs"] += [dict(c) for c in helpers.HELD_BACK["configs"]]
    bench["workloads"].append(dict(promoted))
    for m in bench["per_layer"]:
        if m["name"] == "device_idle_share":
            m["workloads"].append(promoted["name"])
    monkeypatch.setattr(run, "load_benchmark", lambda: json.loads(json.dumps(bench)))
    merged = helpers.bench_with_held_back()
    for key in ("configs", "workloads", "per_layer"):
        names = [e["name"] for e in merged[key]]
        assert len(names) == len(set(names)), key
    for m in merged["per_layer"]:
        assert len(m["workloads"]) == len(set(m["workloads"])), m["name"]
    listed = {m["name"] for m in merged["per_layer"] if promoted["name"] in m["workloads"]}
    assert listed == {"device_idle_share"}  # BENCHMARK.json's lists, not the held-back ones
    want = [w["name"] for w in bench["workloads"] + helpers.HELD_BACK["workloads"][1:]]
    assert [w["name"] for w in merged["workloads"]] == want
