"""Tiny sizes of each cell, run on the CPU through the harness's own
``run_cell``: the benchmark's cells, and the cells whose configuration,
request kind and readers the harness holds for a later benchmark entry
(PERF.md, Open questions)."""

from __future__ import annotations

import copy

from portbench import run

# the cells' files at sizes a CPU test holds; everything else as committed
TINY_CONFIG = {
    "runs_scatter": {"bitmaps": 120},
    "bsi_column": {"rows": 300_000},
}
TINY_MIX = {
    "wide_aggregation": {},
    "slice_histogram": {"params": {"thresholds": 16}},
    "slice_range": {"keep_share": 1.0},
    "boolean_query": {"params": {"groups": 5, "group_size": 20}, "warmup_per_client": 2},
}

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

BENCHMARK_CELLS = tuple(w["name"] for w in run.load_benchmark()["workloads"])
CELLS = BENCHMARK_CELLS + tuple(w["name"] for w in HELD_BACK["workloads"])


def bench_with_held_back() -> dict:
    """BENCHMARK.json with the held-back entries merged in."""
    bench = run.load_benchmark()
    bench["configs"] += HELD_BACK["configs"]
    bench["workloads"] += HELD_BACK["workloads"]
    metrics = {m["name"]: m for m in bench["per_layer"]}
    for m in copy.deepcopy(HELD_BACK["per_layer"]):
        if m["name"] in metrics:
            metrics[m["name"]]["workloads"] += m["workloads"]
        else:
            bench["per_layer"].append(m)
    return bench


def tiny_parts(cell: str, config=None, mix=None):
    """(bench, cfg, mix) of ``cell`` cut to the tiny sizes, with further
    overrides merged in."""
    bench = bench_with_held_back()
    _, cfg, m = run.cell_parts(bench, cell)
    cfg = {**cfg, **TINY_CONFIG[cfg["maker"]], **(config or {})}
    m = copy.deepcopy(m)
    for over in (TINY_MIX[m["kind"]], mix or {}):
        for k, v in over.items():
            if k == "params":
                m["params"].update(v)
            else:
                m[k] = v
    return bench, cfg, m


def tiny_run(cell: str, seed: int = 2**40 + 11, seconds: float = 1.5, trace: bool = False,
             control: bool = False, device: str = "cpu", config=None, mix=None):
    import torch

    bench, cfg, m = tiny_parts(cell, config, mix)
    return run.run_cell(bench, cell, seed, seconds, trace, torch.device(device),
                        control=control, cfg_override=cfg, mix_override=m)
