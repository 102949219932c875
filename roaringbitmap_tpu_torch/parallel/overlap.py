"""Double-buffered host-to-device shipping lane.

Counterpart of ``roaringbitmap_tpu/parallel/overlap.py``. Back-to-back
device queries serialize marshal and compute: pack, ship, reduce, repeat —
the device idles while the host marshals, the host idles while the device
reduces. This module overlaps them: ``prefetch`` stages the NEXT query's
pack and device expansion on a lane thread (the work lands in
``store.PACK_CACHE``, so the consumer's normal ``packed_for`` lookup comes
back resident), and ``wait`` / ``join`` joins the staged work — the only
marshal time the consumer still pays is whatever the previous query's
compute did not hide.

Double-buffered, not queued: at most one staging (``_DEPTH``) is in
flight; a prefetch past the window is dropped (returns None) rather than
growing a backlog of multi-GB working sets. A staging whose consumer never
joined is reaped once it has finished, before the window is declared
full.

**On the card** the lane thread stages under ``torch.cuda.stream`` of a
stream the lane owns: the host pack, the payload concatenated into pinned
host buffers, their ``non_blocking`` copies and the ``rb_expand_rows``
launch all run on it. The lane records an event after staging and
synchronizes on it on the lane thread before it completes the staging.
A pack in ``PACK_CACHE`` is visible to other threads while the lane
writes its rows (a fresh pack once stored, a resident one while it is
delta-patched); ``store.PackedGroups`` orders those writes against reads
on other streams with an event of its own, so no consumer stream reads
rows still being written, joined or not. The pinned buffers are kept
by PyTorch's pinned allocator until the copies that read them have
completed. The staged pack's device tensors were allocated on the lane
stream but are read on, and freed from, the consumer's stream:
:meth:`ShipLane.join` calls ``record_stream`` on every one of them for
the consumer's current stream, so the caching allocator cannot hand a
block back to the lane stream while a consumer kernel still reads it.

Threading: ``threading_mode`` is ``auto`` (threaded when
``os.cpu_count() > 1``), ``on`` or ``off``; off, ``prefetch`` stages
nothing and the consumer packs synchronously — the same bits. The host
pack is Python and numpy, so the lane thread contends for the interpreter
lock with the consumer; ``stats()`` reports the staged seconds and the
share of them hidden behind the consumer's work.

No fallback: the JAX package degrades a non-fatal staging failure to a
synchronous pack at ``wait``; here every staging error re-raises at
``wait`` / ``join`` / ``drain`` (and at a ``prefetch`` that reaps it).

The lane adopts the submitting query's trace id (``observe.context``)
for its staging, so the pack and expansion it runs — with the
``store.ship`` and ``store.expand`` fault sites — are attributed to the
query that will consume them; the consumer's wait is the
``overlap_wait`` pack stage, and ``rb_tpu_store_overlap_ratio{lane}``
carries the overlap ratio.

Lock order: the lane lock is a leaf over the staging bookkeeping only —
the staged job runs outside it (it takes the pack-cache lock), so lane ->
pack cache never nests.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import observe as _observe
from ..device import resolve_device
from ..observe import context as _context
from ..observe import timeline as _timeline
from . import store

_OVERLAP_RATIO = _observe.gauge(
    _observe.STORE_OVERLAP_RATIO,
    "Fraction of staged marshal wall hidden behind compute by the overlap "
    "shipping lane (cumulative)",
    ("lane",),
)

_DEPTH = 1  # stagings in flight: double-buffered


class _Staging:
    __slots__ = ("future", "duration_s", "trace", "flow")

    def __init__(self, future: Future):
        self.future = future
        self.duration_s = 0.0  # staged marshal wall, set by the lane thread
        # the submitting query's trace id (contextvars do not cross into
        # the lane thread: it adopts this one) and the flow id linking the
        # prefetch, the staging and the consumer's wait on the timeline
        self.trace = None
        self.flow = 0


class ShipLane:
    """The double-buffered shipping lane (module singleton ``LANE``)."""

    _MODES = ("auto", "on", "off")

    def __init__(self, threading_mode: str = "auto"):
        if threading_mode not in self._MODES:
            raise ValueError(
                f"lane threading_mode must be one of {self._MODES}, "
                f"got {threading_mode!r}"
            )
        self.threading_mode = threading_mode
        self._lock = threading.Lock()
        self._pending: Dict[tuple, _Staging] = {}  # guarded-by: self._lock
        self._staged_s = 0.0  # guarded-by: self._lock
        self._hidden_s = 0.0  # guarded-by: self._lock
        self._pool: Optional[ThreadPoolExecutor] = None  # guarded-by: self._lock
        self._streams: Dict[int, "torch.cuda.Stream"] = {}  # guarded-by: self._lock

    def configure(self, threading_mode: str) -> None:
        """Pin the lane's threading decision (see the module docstring)."""
        if threading_mode not in self._MODES:
            raise ValueError(
                f"lane threading_mode must be one of {self._MODES}, "
                f"got {threading_mode!r}"
            )
        self.threading_mode = threading_mode

    def threaded(self) -> bool:
        """Is there parallelism for the lane to exploit? (``auto``: yes iff
        the host has more than one core.)"""
        mode = self.threading_mode
        if mode == "on":
            return True
        if mode == "off":
            return False
        return (os.cpu_count() or 1) > 1

    # -- internals ---------------------------------------------------------

    def _executor(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                # named at thread start, so the lane thread is named in a
                # Chrome trace from its first event
                self._pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="rb-ship-lane",
                    initializer=_timeline.register_thread,
                )
            return self._pool

    def _stream(self, device: torch.device) -> "torch.cuda.Stream":
        """The lane's own stream on the CUDA ``device``."""
        index = device.index if device.index is not None else torch.cuda.current_device()
        with self._lock:
            s = self._streams.get(index)
            if s is None:
                s = self._streams[index] = torch.cuda.Stream(device=index)
            return s

    @staticmethod
    def _key(bitmaps: Sequence, marker: str) -> tuple:
        return (marker, tuple(bm.fingerprint() for bm in bitmaps))

    def _stage(self, bitmaps: List, keys_filter: Optional[set], device, st: _Staging):
        """Runs on the lane thread: the real pack and device expansion
        (the ``store.ship`` and ``store.expand`` fault sites live) under
        the submitting query's trace id; the staging duration is the wall
        up to the rows being complete."""
        t0 = time.monotonic()
        try:
            with _context.adopt(st.trace):
                _timeline.flow_point("overlap.handoff", "t", st.flow)
                with _timeline.tspan("overlap.stage", "overlap", n=len(bitmaps)):
                    if device.type != "cuda":
                        packed = store.packed_for(bitmaps, keys_filter, device)
                        _ = packed.device_words
                        return packed
                    stream = self._stream(device)
                    with torch.cuda.stream(stream):
                        packed = store.packed_for(bitmaps, keys_filter, device)
                        _ = packed.device_words  # expanded, or resident and delta-patched
                        event = torch.cuda.Event()
                        event.record(stream)
                    event.synchronize()
                    return packed
        finally:
            st.duration_s = time.monotonic() - t0

    # -- public API --------------------------------------------------------

    def prefetch(self, bitmaps: Sequence, keys_filter: Optional[set] = None, device=None):
        """Stage this working set's pack and expansion on ``device``
        (default ``aggregation.config.device``) on the lane thread.
        Returns the staging ticket, or None when the lane is not threaded
        or the window is full (the double-buffer discipline); a working
        set already staged returns its ticket. Staging failures surface at
        ``wait`` / ``join``; the only one this raises is parked in a
        finished orphan it reaps."""
        if not self.threaded():
            return None
        if device is None:
            from . import aggregation

            device = aggregation.config.device
        device = resolve_device(device)
        bitmaps = list(bitmaps)
        key = self._key(bitmaps, "all" if keys_filter is None else "and")
        reaped: List[_Staging] = []
        with self._lock:
            if key in self._pending:
                return self._pending[key]
            if len(self._pending) >= _DEPTH:
                # a staging whose consumer never joined (e.g. its bitmaps
                # mutated, so the join key no longer matches) must not
                # wedge the window forever: reap finished ones first
                # (their packs stay in the pack cache)
                for k in [k for k, s in self._pending.items() if s.future.done()]:
                    reaped.append(self._pending.pop(k))
            full = len(self._pending) >= _DEPTH
        # surface a reaped orphan's failure BEFORE inserting our own staging
        for orphan in reaped:
            orphan.future.result()
        if full:
            return None
        with self._lock:
            st = self._pending.get(key)
            if st is not None:
                return st
            if len(self._pending) >= _DEPTH:  # lost a concurrent race
                return None
            st = _Staging(Future())
            st.trace = _context.current_trace()
            st.flow = _timeline.flow_id(st.trace, key)
            self._pending[key] = st
        # flow start at the submitter: the handoff arrow runs from here to
        # the lane's staging span and on to the consumer's overlap_wait
        _timeline.flow_point("overlap.handoff", "s", st.flow)

        def _run():
            try:
                st.future.set_result(self._stage(bitmaps, keys_filter, device, st))
            except BaseException as e:  # rb-ok: exception-hygiene -- parked in the future; re-raised at wait/join/drain
                st.future.set_exception(e)

        try:
            self._executor().submit(_run)
        except BaseException:
            # a failed enqueue must not leave a never-completed future in
            # the window (a wait on it would block forever)
            with self._lock:
                self._pending.pop(key, None)
            raise
        return st

    def wait(self, bitmaps: Sequence, keys_filter: Optional[set] = None):
        """Join this working set's staging, if any: the resident pack, or
        None when nothing was staged. A failed staging re-raises here."""
        return self._join(
            self._key(list(bitmaps), "all" if keys_filter is None else "and")
        )

    def join(self, bitmaps: Sequence, op: str = "or"):
        """``wait`` addressed by the op instead of the AND key filter, so
        a consumer that has not paid the dispatch prelude yet can pop its
        staging."""
        return self._join(self._key(list(bitmaps), "and" if op == "and" else "all"))

    def _join(self, key: tuple):
        with self._lock:
            st = self._pending.pop(key, None)
        if st is None:
            return None
        t0 = time.monotonic()
        with _timeline.stage(
            store._PACK_STAGE_SECONDS, "overlap_wait", "pack.overlap_wait", cat="pack",
        ):
            packed = st.future.result()
            _timeline.flow_point("overlap.handoff", "f", st.flow)
        waited = time.monotonic() - t0
        if packed.device.type == "cuda":
            consumer = torch.cuda.current_stream(packed.device)
            for t in packed.device_tensors():
                t.record_stream(consumer)
        with self._lock:
            self._staged_s += st.duration_s
            self._hidden_s += max(0.0, st.duration_s - waited)
            ratio = self._hidden_s / self._staged_s if self._staged_s else 0.0
        _OVERLAP_RATIO.set(round(ratio, 4), ("ship",))
        return packed

    def drain(self) -> None:
        """Join every in-flight staging and drop the bookkeeping (tests,
        mode flips): staged results stay in the pack cache; a failed
        staging re-raises."""
        with self._lock:
            pending = list(self._pending.values())
            self._pending.clear()
        errors = []
        for st in pending:
            try:
                st.future.result()
            except Exception as e:  # rb-ok: exception-hygiene -- every staging is joined before the first error re-raises
                errors.append(e)
        if errors:
            raise errors[0]

    def stats(self) -> dict:
        """Staged seconds, the share of them hidden behind the consumer's
        work (``hidden_s``: staged minus the consumer's wait at join), the
        overlap ratio hidden / staged, and the stagings in flight."""
        with self._lock:
            return {
                "staged_s": self._staged_s,
                "hidden_s": self._hidden_s,
                "overlap_ratio": self._hidden_s / self._staged_s if self._staged_s else 0.0,
                "pending": len(self._pending),
            }

    def reset_stats(self) -> None:
        with self._lock:
            self._staged_s = 0.0
            self._hidden_s = 0.0


LANE = ShipLane()


def run_pipelined(
    jobs: Sequence[Tuple[Sequence, str]], mode: Optional[str] = None, device=None
) -> List:
    """Run back-to-back N-way aggregations with the shipping lane: for each
    ``(bitmaps, op)`` job, the NEXT job's pack and device expansion stage
    on the lane while the current job reduces.

    Equivalent to ``[FastAggregation.<op>(*bitmaps, mode=mode,
    device=device), ...]`` — same engines, same bits; only the staging
    overlaps.

    Every job gets its own pre-assigned trace id, and job i+1's prefetch
    runs under job i+1's id though job i's iteration drives it: the staged
    work is the consumer job's marshal."""
    from . import aggregation

    jobs = [(list(bms), op) for bms, op in jobs]
    tids = [_context.new_trace_id() for _ in jobs]
    out = []
    for i, (bms, op) in enumerate(jobs):
        with _context.trace_scope(tids[i]):
            # join our own staging by op marker; the dispatch prelude (AND
            # key intersection) is left to _aggregate, which pays it once
            LANE.join(bms, op)
        if i + 1 < len(jobs):
            with _context.trace_scope(tids[i + 1]):
                aggregation.prefetch(jobs[i + 1][0], jobs[i + 1][1], mode=mode, device=device)
        with _context.trace_scope(tids[i]):
            out.append(aggregation._aggregate(bms, op, mode, device))
    return out
