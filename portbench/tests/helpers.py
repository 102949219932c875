"""Tiny sizes of each cell, run on the CPU through the harness's own
``run_cell``: the benchmark's cells, and the cells whose configuration,
request kind and readers the harness holds for a later benchmark entry
(PERF.md, Open questions).

A cell's tiny sizes are data, found by name as ``run.py`` finds the cell's
files: ``tiny/configs/<maker>.json`` for its configuration's maker and
``tiny/kinds/<kind>.json`` for its traffic's kind. Either file may hold
``config`` and ``mix``, merged into every tiny run's configuration and mix
(a mix's ``params`` key by key), ``control_config``, merged into a control
run's configuration, ``card_config``, merged into a run on the card's, and
a ``why``. A new cell brings its files; nothing here is edited."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from portbench import run

TINY = Path(__file__).resolve().parent / "tiny"
SECTIONS = ("config", "mix", "control_config", "card_config")

# entries that BENCHMARK.json does not hold yet, in its own form
HELD_BACK = {
    "configs": [{"name": "bsi-100m-u32", "file": "portbench/configs/bsi-100m-u32.json"}],
    "workloads": [
        {"name": "runs10k-wideagg", "config": "runs-scatter-10k", "traffic": "wideagg", "chips": 1},
        {"name": "bsi100m-histogram", "config": "bsi-100m-u32", "traffic": "histogram", "chips": 1},
        {"name": "bsi100m-filter", "config": "bsi-100m-u32", "traffic": "filter", "chips": 1},
    ],
    "per_layer": [
        {"name": "device_idle_share",
         "workloads": ["runs10k-wideagg", "bsi100m-histogram", "bsi100m-filter"]},
        {"name": "pack_hit_share",
         "workloads": ["runs10k-wideagg", "bsi100m-histogram", "bsi100m-filter"]},
        {"name": "unpack_ms", "workloads": ["bsi100m-filter"]},
        {"name": "kernel_roofline", "unit": "%", "better": "higher", "source": "device_trace",
         "layer": "Kernels", "moves": "qps",
         "workloads": ["runs10k-wideagg", "bsi100m-histogram", "bsi100m-filter"]},
        {"name": "d2h_ms", "unit": "ms", "better": "lower", "source": "device_trace",
         "layer": "Copy to host", "moves": "qps", "workloads": ["bsi100m-filter"]},
    ],
}


def bench_with_held_back() -> dict:
    """BENCHMARK.json with the held-back entries merged in. A held-back
    configuration or cell that BENCHMARK.json already holds is skipped, and
    so is a cell in a held-back metric's list: once promoted, a cell counts
    once and its metrics are BENCHMARK.json's."""
    bench = run.load_benchmark()
    cells = {w["name"] for w in bench["workloads"]}
    configs = {c["name"] for c in bench["configs"]}
    bench["configs"] += [c for c in HELD_BACK["configs"] if c["name"] not in configs]
    bench["workloads"] += [w for w in HELD_BACK["workloads"] if w["name"] not in cells]
    metrics = {m["name"]: m for m in bench["per_layer"]}
    for m in copy.deepcopy(HELD_BACK["per_layer"]):
        m["workloads"] = [w for w in m["workloads"] if w not in cells]
        if not m["workloads"]:
            continue
        if m["name"] in metrics:
            metrics[m["name"]]["workloads"] += m["workloads"]
        else:
            bench["per_layer"].append(m)
    return bench


BENCHMARK_CELLS = tuple(w["name"] for w in run.load_benchmark()["workloads"])
CELLS = tuple(w["name"] for w in bench_with_held_back()["workloads"])


def tiny_sizes(group: str, name: str) -> dict:
    """The tiny-size file of the maker (``group`` ``configs``) or the kind
    (``kinds``) ``name``."""
    path = TINY / group / f"{name}.json"
    if not path.is_file():
        what = "maker" if group == "configs" else "kind"
        raise FileNotFoundError(
            f"no tiny sizes for the {what} {name!r}: add {path}, a JSON object of any of "
            f"{', '.join(SECTIONS)} (an empty object where the committed sizes fit a CPU test)")
    sizes = json.loads(path.read_text())
    unknown = set(sizes) - set(SECTIONS) - {"why"}
    if unknown:
        raise ValueError(f"{path}: unknown keys {sorted(unknown)}; known: {SECTIONS} and why")
    return sizes


def tiny_parts(cell: str, config=None, mix=None, control: bool = False, card: bool = False,
               bench: dict = None):
    """(bench, cfg, mix) of ``cell`` cut to the tiny sizes of its maker and
    kind (with their control or card sizes), with further overrides merged
    in. ``bench`` defaults to ``bench_with_held_back()``."""
    bench = bench or bench_with_held_back()
    _, cfg, m = run.cell_parts(bench, cell)
    files = (tiny_sizes("configs", cfg["maker"]), tiny_sizes("kinds", m["kind"]))
    sections = ("config",) + ("control_config",) * control + ("card_config",) * card
    cfg = dict(cfg)
    for section in sections:
        for sizes in files:
            cfg.update(sizes.get(section, {}))
    cfg.update(config or {})
    m = copy.deepcopy(m)
    for over in [sizes.get("mix", {}) for sizes in files] + [mix or {}]:
        for k, v in over.items():
            if k == "params":
                m["params"].update(v)
            else:
                m[k] = v
    return bench, cfg, m


def tiny_run(cell: str, seed: int = 2**40 + 11, seconds: float = 1.5, trace: bool = False,
             control: bool = False, device: str = "cpu", config=None, mix=None,
             bench: dict = None):
    import torch

    dev = torch.device(device)
    bench, cfg, m = tiny_parts(cell, config, mix, control, dev.type == "cuda", bench)
    return run.run_cell(bench, cell, seed, seconds, trace, dev,
                        control=control, cfg_override=cfg, mix_override=m)
