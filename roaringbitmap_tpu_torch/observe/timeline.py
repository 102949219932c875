"""Pipeline timeline tracer: a flight recorder for the marshal path.

Counterpart of ``roaringbitmap_tpu/observe/timeline.py``. The metrics
registry answers "how much, how many" in aggregate; it cannot answer
*where inside* a cold pack or a delta repack the time went, in what
order, or on which thread. This module keeps a thread-safe, bounded ring
buffer of structured trace events (name, category, start/duration in
monotonic ns, thread id, free-form attrs like rows/bytes/cache kind) and
exports it as Chrome trace-event JSON, loadable in Perfetto /
chrome://tracing.

Three recording modes, chosen by ``RB_TPU_TIMELINE`` (read once at import;
``configure()`` overrides at runtime):

* **unset / "off"** — recording disabled. A ``tspan`` site reduces to
  one module-int comparison and builds no span object; no events, no
  attrs dicts retained.
* **"on"** — spans and instants record into the ring buffer and feed the
  ``rb_tpu_timeline_span_seconds{cat}`` latency histogram. Device work is
  timed as *launched*: CUDA kernels run asynchronously, so a span may end
  before its kernels do.
* **"fenced"** — additionally, ``fence(x)`` synchronises the CUDA stream
  of a device tensor inside its producing span, so a span's duration is
  the device-inclusive wall time. This perturbs pipelining — it is a
  diagnosis mode, not a production default. A CPU tensor needs no fence.

Every span (``observe.spans.span``, and so every ``tracing.op_timer``,
``stage`` and ``tspan`` block) records into the recorder when a mode is
active, on the clock its span read. ``stage`` and ``op_timer`` time in
every mode; ``tspan`` is a span only while a mode is active. A span's
``torch.profiler`` range is the span's own business: it opens whenever a
profiler records, whatever the mode.

**Dump-on-anomaly**: when a span exceeds the configured budget
(``RB_TPU_TIMELINE_BUDGET_MS`` / ``configure(budget_ms=...)``), the whole
flight recorder flushes to a JSONL artifact (``RB_TPU_TIMELINE_DUMP``,
default ``rb_tpu_timeline_anomaly.jsonl`` inside the artifact sink
``RB_TPU_ARTIFACT_DIR`` — see ``observe.artifacts``; a path with a
directory component is honoured verbatim). Dumps are throttled to one per
second; ``rb_tpu_timeline_anomaly_total{cat}`` counts every trigger.

Lock discipline: the recorder lock is a leaf — record() never acquires any
other lock, so call sites holding the pack-cache or registry lock nest
safely over it.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, Iterable, List, Optional

from . import context as _context
from . import registry as _registry
from . import spans as _spans
from .histogram import latency_histogram

OFF, ON, FENCED = 0, 1, 2
_MODE_NAMES = {"off": OFF, "on": ON, "fenced": FENCED}

DEFAULT_CAPACITY = 65536
DUMP_SCHEMA = "rb_tpu_timeline/1"

_SPAN_SECONDS = latency_histogram(
    _registry.TIMELINE_SPAN_SECONDS,
    "Wall time of flight-recorder timeline spans by category",
    ("cat",),
)
_ANOMALY_TOTAL = _registry.counter(
    _registry.TIMELINE_ANOMALY_TOTAL,
    "Spans that exceeded the timeline anomaly budget and triggered a "
    "flight-recorder dump",
    ("cat",),
)


class TimelineEvent:
    """One recorded event. ``ph`` follows the trace-event format: ``"X"``
    (complete span, has ``dur_ns``), ``"i"`` (instant), or ``"s"``/``"t"``/
    ``"f"`` (flow start/step/finish — producer/consumer links across
    threads; the flow id lives in ``attrs["flow"]``). ``trace`` is the
    query-scoped trace id active when the event was recorded — None
    outside any trace scope."""

    __slots__ = ("name", "cat", "ph", "ts_ns", "dur_ns", "tid", "attrs", "trace")

    def __init__(self, name, cat, ph, ts_ns, dur_ns, tid, attrs, trace=None):
        self.name = name
        self.cat = cat
        self.ph = ph
        self.ts_ns = ts_ns
        self.dur_ns = dur_ns
        self.tid = tid
        self.attrs = attrs
        self.trace = trace

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "cat": self.cat,
            "ph": self.ph,
            "ts_us": self.ts_ns / 1e3,
            "tid": self.tid,
        }
        if self.ph == "X":
            d["dur_us"] = self.dur_ns / 1e3
        if self.trace is not None:
            d["trace"] = self.trace
        if self.attrs:
            d["args"] = dict(self.attrs)
        return d


class FlightRecorder:
    """Bounded ring buffer of :class:`TimelineEvent`. O(1) record under one
    leaf lock; when full, the oldest events are overwritten and counted as
    ``dropped()`` — a flight recorder keeps the *latest* window, which is
    the window that explains an anomaly."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._lock = threading.Lock()
        self._buf: List[Optional[TimelineEvent]] = [None] * int(capacity)  # guarded-by: self._lock
        self._total = 0  # guarded-by: self._lock

    @property
    def capacity(self) -> int:
        return len(self._buf)

    def record(self, ev: TimelineEvent) -> None:
        with self._lock:
            self._buf[self._total % len(self._buf)] = ev
            self._total += 1

    def events(self) -> List[TimelineEvent]:
        """Point-in-time copy in recording (≈ end-time) order."""
        with self._lock:
            n, cap = self._total, len(self._buf)
            if n <= cap:
                return list(self._buf[:n])
            i = n % cap
            return self._buf[i:] + self._buf[:i]

    def __len__(self) -> int:
        with self._lock:
            return min(self._total, len(self._buf))

    def total(self) -> int:
        """Events ever recorded (retained + overwritten)."""
        with self._lock:
            return self._total

    def dropped(self) -> int:
        with self._lock:
            return max(0, self._total - len(self._buf))

    def clear(self) -> None:
        with self._lock:
            self._buf = [None] * len(self._buf)
            self._total = 0

    def resize(self, capacity: int) -> None:
        """Re-bound the buffer, keeping the newest events that fit."""
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        kept = self.events()[-capacity:]
        with self._lock:
            self._buf = kept + [None] * (capacity - len(kept))
            self._total = len(kept)


# The process-wide recorder every instrumented module records into.
RECORDER = FlightRecorder()

# thread-id -> name, refreshed on every record so the Chrome trace carries
# thread_name metadata without growing each event
_THREAD_NAMES: Dict[int, str] = {}  # guarded-by: _STATE_LOCK

_STATE_LOCK = threading.Lock()
_MODE = OFF  # guarded-by: _STATE_LOCK (reads are lock-free int loads)
_BUDGET_NS: Optional[int] = None  # guarded-by: _STATE_LOCK
_DUMP_PATH = "rb_tpu_timeline_anomaly.jsonl"  # guarded-by: _STATE_LOCK
_LAST_DUMP_NS = 0  # guarded-by: _STATE_LOCK
_DUMP_MIN_INTERVAL_NS = 1_000_000_000


def _init_from_env() -> None:
    raw = os.environ.get("RB_TPU_TIMELINE", "").strip().lower()
    if raw in _MODE_NAMES:
        mode = raw
    elif raw in ("", "0", "false", "no"):
        mode = "off"
    else:  # any other truthy value: plain recording
        mode = "on"
    budget = os.environ.get("RB_TPU_TIMELINE_BUDGET_MS")
    cap = os.environ.get("RB_TPU_TIMELINE_CAPACITY")
    configure(
        mode=mode,
        budget_ms=float(budget) if budget else None,
        dump_path=os.environ.get("RB_TPU_TIMELINE_DUMP") or None,
        capacity=int(cap) if cap else None,
    )


def configure(
    mode=None,
    budget_ms: Optional[float] = None,
    dump_path: Optional[str] = None,
    capacity: Optional[int] = None,
) -> None:
    """Runtime override of the env-derived config. ``mode`` accepts
    "off"/"on"/"fenced" or the module constants; ``budget_ms`` <= 0
    disables the anomaly hook; others keep their current value when None."""
    global _MODE, _BUDGET_NS, _DUMP_PATH
    with _STATE_LOCK:
        if mode is not None:
            if isinstance(mode, str):
                if mode not in _MODE_NAMES:
                    raise ValueError(f"unknown timeline mode {mode!r}")
                mode = _MODE_NAMES[mode]
            if mode not in (OFF, ON, FENCED):
                raise ValueError(f"unknown timeline mode {mode!r}")
            _MODE = mode
        if budget_ms is not None:
            _BUDGET_NS = int(budget_ms * 1e6) if budget_ms > 0 else None
        if dump_path is not None:
            _DUMP_PATH = dump_path
    if capacity is not None:
        RECORDER.resize(capacity)


def enabled() -> bool:
    """Is the flight recorder recording at all?"""
    return _MODE != OFF


def fenced() -> bool:
    """Are instrumented sites fencing device values (RB_TPU_TIMELINE=fenced)?"""
    return _MODE == FENCED


def mode_name() -> str:
    return {OFF: "off", ON: "on", FENCED: "fenced"}[_MODE]


def fence(x):
    """Synchronise the CUDA stream ``x`` was produced on when fencing is
    active — call inside the producing span so its duration includes the
    device work it launched. A CPU tensor, a host value or None needs no
    fence. No-op (one int compare) in every other mode; returns ``x``
    either way so call sites stay expression-shaped."""
    if _MODE == FENCED and getattr(x, "is_cuda", False):
        import torch

        torch.cuda.current_stream(x.device).synchronize()
    return x


def register_thread(name: Optional[str] = None) -> None:
    """Eagerly register this thread's display name for the Chrome-trace
    ``thread_name`` metadata (mode-independent). Recording registers names
    lazily as a backstop, but a dedicated worker (the overlap lane) must
    register at thread start so it is named from its very first event —
    a bare tid in Perfetto is an attribution dead end."""
    tid = threading.get_ident()
    with _STATE_LOCK:
        _THREAD_NAMES[tid] = name or threading.current_thread().name


def thread_names() -> Dict[int, str]:
    """Point-in-time copy of the tid -> display-name registry."""
    with _STATE_LOCK:
        return dict(_THREAD_NAMES)


def _record_complete(name, cat, t0_ns, dur_ns, attrs) -> None:
    tid = threading.get_ident()
    with _STATE_LOCK:
        _THREAD_NAMES[tid] = threading.current_thread().name
        budget = _BUDGET_NS
    RECORDER.record(
        TimelineEvent(
            name, cat, "X", t0_ns, dur_ns, tid, attrs,
            trace=_context.current_trace(),
        )
    )
    _SPAN_SECONDS.observe(dur_ns / 1e9, (cat,))
    if budget is not None and dur_ns > budget:
        _anomaly(name, cat, dur_ns, budget)


def instant(name: str, cat: str = "event", /, **attrs) -> None:
    """Record a zero-duration marker (cache hit/miss/evict, epoch flip).
    ``name``/``cat`` are positional-only so attrs may carry those keys
    (decision inputs are arbitrary key/value pairs)."""
    if _MODE == OFF:
        return
    tid = threading.get_ident()
    with _STATE_LOCK:
        _THREAD_NAMES[tid] = threading.current_thread().name
    RECORDER.record(
        TimelineEvent(
            name, cat, "i", time.perf_counter_ns(), 0, tid, attrs or None,
            trace=_context.current_trace(),
        )
    )


def flow_point(name: str, phase: str, flow_id: int, cat: str = "flow") -> None:
    """Record one flow event: ``phase`` is ``"s"`` (start, at the
    producer), ``"t"`` (step), or ``"f"`` (finish, at the consumer).
    Events sharing a ``flow_id`` render as one arrow chain in Perfetto —
    the cross-thread producer/consumer link (e.g. a query's prefetch
    handoff to the overlap lane and back to its ``overlap_wait``) that
    same-thread nesting cannot express. No-op when recording is off."""
    if _MODE == OFF:
        return
    if phase not in ("s", "t", "f"):
        raise ValueError(f"flow phase must be 's'/'t'/'f', got {phase!r}")
    tid = threading.get_ident()
    with _STATE_LOCK:
        _THREAD_NAMES[tid] = threading.current_thread().name
    RECORDER.record(
        TimelineEvent(
            name, cat, phase, time.perf_counter_ns(), 0, tid,
            {"flow": int(flow_id)}, trace=_context.current_trace(),
        )
    )


def flow_id(*parts) -> int:
    """A stable 32-bit flow id from hashable parts (trace id + handoff
    key): producer and consumer compute the same id independently."""
    import zlib

    return zlib.crc32(repr(parts).encode()) & 0x7FFFFFFF


class _Span(_spans.Span):
    """A recording span (only ever constructed while a mode is active);
    ``with`` yields the span itself, so a caller can ``attr()`` it."""

    __slots__ = ()

    def attr(self, **kw) -> None:
        """Attach attrs discovered mid-span (e.g. the serving epoch a
        request was pinned to, known only after admission) — recorded at
        exit with the rest. Callers must guard for off-mode, where tspan
        returns a span-less null context."""
        if self.attrs:
            self.attrs.update(kw)
        else:
            self.attrs = dict(kw)

    def __enter__(self) -> "_Span":
        super().__enter__()
        return self


_NULL = contextlib.nullcontext()


def tspan(name: str, cat: str = "host", **attrs):
    """A span that exists only while the flight recorder records: the
    enclosed block timed as ``observe.spans.span`` times it. Disabled mode
    returns a shared null context — no span object exists."""
    if _MODE == OFF:
        return _NULL
    return _Span(name, cat, None, (), attrs)


def stage(hist, label, name: Optional[str] = None, cat: str = "stage", **attrs):
    """Time one pipeline stage: a span (``observe.spans.span``, in every
    mode) that also observes the stage's latency histogram ``hist`` under
    ``label``. This is the instrumentation primitive the marshal pipeline
    uses: the histogram gives p50/p99 over the run, the recorder gives the
    one-run decomposition."""
    labels = (label,) if isinstance(label, str) else tuple(label)
    return _spans.Span(name or "/".join(labels), cat, hist, labels, attrs)


# ---------------------------------------------------------------------------
# anomaly dump
# ---------------------------------------------------------------------------


def _anomaly(name: str, cat: str, dur_ns: int, budget_ns: int) -> None:
    global _LAST_DUMP_NS
    _ANOMALY_TOTAL.inc(1, (cat,))
    instant(
        "timeline.anomaly", "anomaly",
        span=name, span_cat=cat,
        dur_ms=round(dur_ns / 1e6, 3), budget_ms=round(budget_ns / 1e6, 3),
    )
    now = time.perf_counter_ns()
    with _STATE_LOCK:
        if now - _LAST_DUMP_NS < _DUMP_MIN_INTERVAL_NS and _LAST_DUMP_NS:
            return
        _LAST_DUMP_NS = now
        path = _DUMP_PATH
    trigger = {
        "span": name, "cat": cat,
        "dur_ms": round(dur_ns / 1e6, 3),
        "budget_ms": round(budget_ns / 1e6, 3),
    }
    # snapshot NOW (cheap list copy under the leaf recorder lock), write on
    # a daemon thread: anomalous spans routinely fire while the caller
    # holds a framework lock (the delta stages run under the process-wide
    # PACK_CACHE lock), and blocking file I/O there would turn one slow
    # entry into a process-wide stall
    events = RECORDER.events()
    dropped = RECORDER.dropped()

    def _write():
        try:
            _dump_events(path, events, RECORDER.capacity, dropped, trigger)
        except OSError:  # diagnostics must never kill the instrumented pipeline; the anomaly counter above still recorded the trigger
            pass

    threading.Thread(
        target=_write, name="rb-timeline-dump", daemon=True
    ).start()


def dump_jsonl(
    path: str,
    recorder: Optional[FlightRecorder] = None,
    trigger: Optional[dict] = None,
) -> None:
    """Flush the flight recorder to a JSONL artifact: a header line
    (schema, capacity, dropped count, optional anomaly trigger) followed by
    one event per line in recording order. Atomic write."""
    rec = RECORDER if recorder is None else recorder
    _dump_events(path, rec.events(), rec.capacity, rec.dropped(), trigger)


def _dump_events(path, events, capacity, dropped, trigger) -> None:
    from . import artifacts as _artifacts
    from .export import _atomic_write

    # a bare-filename dump path (the default) lands in the artifact sink,
    # never loose in the working directory
    path = _artifacts.resolve(path)
    header = {
        "schema": DUMP_SCHEMA,
        "generated_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "capacity": capacity,
        "dropped": dropped,
        "events": len(events),
    }
    if trigger is not None:
        header["trigger"] = trigger
    lines = [json.dumps(header, sort_keys=True)]
    lines.extend(json.dumps(e.to_dict(), sort_keys=True) for e in events)
    _atomic_write(path, "\n".join(lines) + "\n")


# ---------------------------------------------------------------------------
# Chrome trace-event / Perfetto export
# ---------------------------------------------------------------------------


def chrome_trace(
    events: Optional[Iterable[TimelineEvent]] = None,
    meta: Optional[dict] = None,
) -> dict:
    """The trace-event-format object (JSON Object Format): ``traceEvents``
    with ``ph: "X"`` complete spans and ``ph: "i"`` instants, ``ts``/``dur``
    in microseconds, plus thread_name metadata — loadable in Perfetto and
    chrome://tracing as-is. ``meta`` lands under ``otherData`` (the format's
    designated extra-info key)."""
    evs = RECORDER.events() if events is None else list(events)
    pid = os.getpid()
    out: List[dict] = []
    tids = set()
    for e in evs:
        tids.add(e.tid)
        rec = {
            "name": e.name,
            "cat": e.cat,
            "ph": e.ph,
            "pid": pid,
            "tid": e.tid,
            "ts": e.ts_ns / 1e3,
        }
        if e.ph == "X":
            rec["dur"] = e.dur_ns / 1e3
        elif e.ph in ("s", "t", "f"):
            # flow events: the id binds start/step/finish into one arrow;
            # "bp": "e" binds the finish to its enclosing slice
            rec["id"] = (e.attrs or {}).get("flow", 0)
            if e.ph == "f":
                rec["bp"] = "e"
        else:
            rec["s"] = "t"
        args = dict(e.attrs) if e.attrs else {}
        if e.trace is not None:
            args["trace"] = e.trace
        if args:
            rec["args"] = args
        out.append(rec)
    with _STATE_LOCK:
        names = {tid: _THREAD_NAMES.get(tid) for tid in tids}
    for tid in sorted(tids):
        if names.get(tid):
            out.append(
                {
                    "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                    "args": {"name": names[tid]},
                }
            )
    trace = {"displayTimeUnit": "ms", "traceEvents": out}
    if meta is not None:
        trace["otherData"] = meta
    return trace


def write_chrome_trace(
    path: str,
    events: Optional[Iterable[TimelineEvent]] = None,
    meta: Optional[dict] = None,
) -> None:
    from .export import _atomic_write

    _atomic_write(path, json.dumps(chrome_trace(events, meta), indent=1) + "\n")


def stage_totals(
    events: Iterable[TimelineEvent],
    names: Iterable[str],
    per_trace: bool = False,
):
    """Sum complete-span durations (seconds) per stage name, restricted to
    ``names`` — the attribution primitive that checks how much of a
    measured wall clock named stages account for. The caller picks a
    non-overlapping stage set; nested helper spans are simply not named.

    ``per_trace=True`` keys the sums by the events' query trace ids:
    ``{trace_id_or_"": {stage: seconds}}`` — a multi-query run
    decomposes per query (events recorded outside any trace scope land
    under ``""``)."""
    wanted = set(names)
    if not per_trace:
        out: Dict[str, float] = {n: 0.0 for n in wanted}
        for e in events:
            if e.ph == "X" and e.name in wanted:
                out[e.name] += e.dur_ns / 1e9
        return out
    by_trace: Dict[str, Dict[str, float]] = {}
    for e in events:
        if e.ph == "X" and e.name in wanted:
            tr = by_trace.setdefault(e.trace or "", {})
            tr[e.name] = tr.get(e.name, 0.0) + e.dur_ns / 1e9
    return by_trace


_init_from_env()
