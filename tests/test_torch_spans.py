"""The port's one span primitive (``observe.spans``) against the profiler
and its own books.

A span opened on a client thread lands in a ``torch.profiler`` trace as a
named range over the work it holds, on the profiler's clock; with no
profiler running no range is ever opened; a span's self time is its
duration less its children's; a region that two instruments timed under
one name is one record; and the benchmark's trace reader names an idle
gap by the innermost port span over it. All on the CPU.
"""

import threading
import time

import numpy as np
import pytest
import torch

from portbench import trace as ptrace
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch import query as tq
from roaringbitmap_tpu_torch import tracing
from roaringbitmap_tpu_torch.observe import spans, timeline
from roaringbitmap_tpu_torch.parallel import aggregation


def _delta(before, after, name, key="count"):
    return after.get(name, {}).get(key, 0) - before.get(name, {}).get(key, 0)


def test_a_worker_span_is_a_user_annotation_nested_in_its_parent():
    def work():
        with spans.span("spans.test.outer"):
            with tracing.op_timer("spans.test.inner"):
                torch.ones(256).sum()
            time.sleep(0.002)

    with ptrace.profiled() as holder:
        t = threading.Thread(target=work, name="client-0")
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    marks = {e["name"]: e for e in holder["trace"]
             if e.get("ph") == "X" and e.get("name", "").startswith("spans.test.")}
    assert set(marks) == {"spans.test.outer", "spans.test.inner"}
    outer, inner = marks["spans.test.outer"], marks["spans.test.inner"]
    assert {outer["cat"].lower(), inner["cat"].lower()} == {"user_annotation"}
    assert outer["tid"] == inner["tid"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_no_profiler_no_record_function(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(self.name)
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    hist = timeline._SPAN_SECONDS
    with spans.span("spans.test.a"), tracing.op_timer("spans.test.b"), tracing.annotate("spans.test.c"):
        with timeline.stage(hist, "spans.test", "spans.test.d"):
            pass
    assert entered == []
    # the guard is what stops it: under a profiler the same spans open ranges
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with spans.span("spans.test.a"), tracing.annotate("spans.test.c"):
            pass
    assert entered == ["spans.test.a", "spans.test.c"]


def test_self_time_is_the_total_less_the_children():
    before = tracing.timings()
    with spans.span("spans.test.parent"):
        time.sleep(0.02)
        for _ in range(2):
            with spans.span("spans.test.child"):
                time.sleep(0.015)
    after = tracing.timings()
    total = _delta(before, after, "spans.test.parent", "total_s")
    own = _delta(before, after, "spans.test.parent", "self_s")
    children = _delta(before, after, "spans.test.child", "total_s")
    assert children >= 0.03 and own >= 0.02
    assert abs(own - (total - children)) < 1e-3
    # a leaf's self time is its total
    assert abs(_delta(before, after, "spans.test.child", "self_s") - children) < 1e-3


def test_plan_and_execute_count_once_per_call(monkeypatch):
    monkeypatch.setattr(aggregation.config, "device", "cpu")
    rng = np.random.default_rng(5)
    latency = tq.exec._QUERY_LATENCY
    before = tracing.timings()
    plans_before = (latency.series().get(("plan",)) or {"count": 0})["count"]
    n = 3
    for _ in range(n):
        bms = [TRB(rng.choice(200_000, 3_000, replace=False)) for _ in range(4)]
        leaves = [tq.Q.leaf(b) for b in bms]
        expr = (leaves[0] | leaves[1]) - leaves[2] | tq.Q.threshold(2, *leaves)
        tq.execute(expr, cache=None, mode="device")
    after = tracing.timings()
    for name in ("query.request", "query.plan", "query.execute"):
        assert _delta(before, after, name) == n, name
    assert latency.series()[("plan",)]["count"] == plans_before + n
    paths = spans.span_timings()
    assert "query.request/query.plan" in paths
    assert not any(p.endswith("query.plan/query.plan") for p in paths)
    assert not any(p.endswith("query.execute/query.execute") for p in paths)


def test_an_idle_gap_is_named_by_the_port_span_holding_it():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": ptrace.WINDOW_SPAN, "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 200},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 900, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "portbench.query.execute", "ts": 50, "dur": 920},
        {"ph": "X", "cat": "user_annotation", "name": "query.request", "ts": 55, "dur": 910},
        {"ph": "X", "cat": "user_annotation", "name": "query.execute", "ts": 300, "dur": 650},
        {"ph": "X", "cat": "user_annotation", "name": "query.andnot.assemble", "ts": 400, "dur": 450},
    ]
    w = ptrace.read_window(ev)
    assert w.idle_gaps == [("query.andnot.assemble", pytest.approx(700e-6))]
