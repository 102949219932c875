"""The result line, the traced window's reading, and BENCHMARK.json
against the benchmark's contract."""

from __future__ import annotations

import importlib
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run, trace
from portbench.tests.helpers import BENCHMARK_CELLS, CELLS, bench_with_held_back, tiny_run

ROOT = Path(run.__file__).resolve().parents[1]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_the_line_has_exactly_the_keys_and_the_checks_last():
    res, lines = tiny_run("runs10k-wideagg", seconds=1.0)
    assert list(res) == KEYS + ["checks"]
    assert set(res["metrics"]) == {"qps", "p95_ms", "setup_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())
    assert lines[-3:] == [
        f"check wrong_answers {res['checks']['wrong_answers']['value']} <= limit 0",
        f"check failed_requests {res['failed']} <= limit 0",
        f"check compared_answers {res['checks']['compared_answers']['value']} >= limit 1",
    ]


def _window(busy=0.25):
    return trace.DeviceWindow(window_s=1.0, busy_s=busy, kernel_s=busy * 0.9, dtoh_s=0.01,
                              device_ops=[("k", 0.2)], idle_gaps=[("host", 0.5)])


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_line_adds_the_breakdown_and_the_cells_per_layer_metrics(monkeypatch, cell):
    monkeypatch.setattr(trace, "read_window", lambda events: _window())
    res, _ = tiny_run(cell, seconds=1.0, trace=True)
    assert list(res) == KEYS + ["breakdown", "checks"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["busy_s"] == 0.25 and res["device"]["window_s"] == 1.0
    want = {m["name"] for m in bench_with_held_back()["per_layer"] if cell in m["workloads"]}
    assert set(res["metrics"]) == want


def test_a_cpu_trace_has_no_device_events_and_fails():
    with pytest.raises(trace.NoDeviceEvents):
        tiny_run("runs10k-wideagg", seconds=0.5, trace=True)


def test_the_window_takes_the_union_of_device_intervals():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW_SPAN, "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 100, "dur": 200},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 150, "dur": 200},  # overlaps a
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pageable)", "ts": 600, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "c", "ts": 950, "dur": 200},  # clipped at 1000
        {"ph": "X", "cat": "cpu_op", "name": "host-work", "ts": 350, "dur": 250},
    ]
    w = trace.read_window(ev)
    assert w.window_s == pytest.approx(1000e-6)
    assert w.busy_s == pytest.approx((250 + 100 + 50) * 1e-6)  # not 550
    assert w.kernel_s == pytest.approx(300e-6)
    assert w.dtoh_s == pytest.approx(100e-6)
    assert w.idle_gaps[0] == ("host-work", pytest.approx(250e-6))
    assert len(w.device_ops) <= trace.TOP and len(w.idle_gaps) <= trace.TOP
    with pytest.raises(trace.NoDeviceEvents):
        trace.read_window([ev[0], ev[-1]])


def test_without_a_card_the_command_prints_no_result_and_fails():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run the cell")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", BENCHMARK_CELLS[0],
                        "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _keeps_to_the_contract(bench: dict) -> None:
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"] and 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]]
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        importlib.import_module(f"portbench.configs.{cfg['maker']}")
    cells = [w["name"] for w in bench["workloads"]]
    assert 1 <= len(cells) == len(set(cells))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert w["config"] in names and len(w["why"]) <= 200
        mix = json.loads((ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
        importlib.import_module(f"portbench.kinds.{mix['kind']}")
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert {"qps", "p95_ms", "setup_s"} <= e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        importlib.import_module(f"portbench.metrics.{m['name']}")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(cells)
    for cell in cells:
        assert len(run.reported(bench, cell, True)) >= 1
        assert {m["name"] for m in run.reported(bench, cell, False)} >= {"setup_s", "qps"}
    for n in names + cells:
        assert NAME.match(n)
    # a quarter of the cells, rounded down, may take four chips; one always may
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(cells) // 4)


def test_benchmark_json_keeps_to_the_contract():
    _keeps_to_the_contract(json.loads((ROOT / "BENCHMARK.json").read_text()))


@pytest.mark.parametrize("cells, four, admitted",
                         [(1, 1, True), (4, 1, True), (4, 2, False), (8, 2, True), (8, 3, False)])
def test_the_contract_admits_four_chips_in_a_quarter_of_the_cells(cells, four, admitted):
    """BENCHMARK.json's first cell in place of its cells, copied under new
    names, the first ``four`` of them on four chips; the metrics are the
    first cell's, each listing every copy."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    first = bench["workloads"][0]
    bench["workloads"] = [{**first, "name": f"{first['name']}-{i}", "chips": 4 if i < four else 1}
                          for i in range(cells)]
    for key in ("end_to_end", "per_layer"):
        bench[key] = [m for m in bench[key] if first["name"] in m.get("workloads", [first["name"]])]
        for m in bench[key]:
            if "workloads" in m:
                m["workloads"] = [w["name"] for w in bench["workloads"]]
    if admitted:
        _keeps_to_the_contract(bench)
    else:
        with pytest.raises(AssertionError):
            _keeps_to_the_contract(bench)
