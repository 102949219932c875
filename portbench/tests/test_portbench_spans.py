"""The per-layer metrics that read the port's spans: a traced query run
prints them, and the executor's self time is a part of its whole time."""

from __future__ import annotations

from portbench import trace
from portbench.tests.helpers import tiny_run


def _window(busy=0.25):
    return trace.DeviceWindow(window_s=1.0, busy_s=busy, kernel_s=busy * 0.9, dtoh_s=0.01,
                              device_ops=[("k", 0.2)], idle_gaps=[("host", 0.5)])


def test_a_traced_query_run_reads_the_port_spans(monkeypatch):
    from portbench.metrics import exec_self_ms

    monkeypatch.setattr(trace, "read_window", lambda events: _window())
    seen = {}
    read = exec_self_ms.read

    def capture(r):
        seen["execute_ms"] = r.per_request_ms("query.execute")
        return read(r)

    monkeypatch.setattr(exec_self_ms, "read", capture)
    res, _ = tiny_run("runs10k-query", seconds=1.0, trace=True)
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert {"exec_self_ms", "pack_build_ms", "fetch_ms", "result_hit_share"} <= set(m)
    assert 0 < m["exec_self_ms"] < seen["execute_ms"]
    assert m["fetch_ms"] > 0 and m["pack_build_ms"] >= 0
    assert 0 <= m["result_hit_share"] <= 100
