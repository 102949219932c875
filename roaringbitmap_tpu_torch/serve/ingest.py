"""Batched streaming ingestion: the serving tier's write path.

Counterpart of ``roaringbitmap_tpu/serve/ingest.py``. Mutations enter the
system as stamped batches in a bounded mutation log while readers keep
serving the current epoch's packs untouched; the epoch flip
(``serve/epochs.py``) drains the log through the sorted-stream writer
(``models/writer.BitmapWriter(into=...)``) into one delta repack per
touched working set.

* :class:`MutationBatch` — one tenant's batch of per-bitmap additions,
  stamped at ingest (``stamp``, injectable for fake clocks). At publish
  the flip observes ``now - stamp`` into
  ``rb_tpu_serve_freshness_seconds{tenant}`` for every batch the new
  epoch makes queryable: the ingest->queryable lag beside the latency
  SLOs.
* :class:`IngestLog` — the thread-safe bounded log. ``submit()`` is the
  only write entry point (one append under a leaf lock and a counter
  bump; writers never touch the corpus, so readers are never blocked by
  ingestion); ``drain()`` is called by the flip and empties it. The live
  depth is ``rb_tpu_serve_mutlog_count`` (the ``epoch-flip-stall`` rule's
  gauge).
* :func:`merge_batches` / :func:`apply_merged` / :func:`apply_batches` —
  the flip's repack-side helpers: one sorted, deduplicated value array
  per touched bitmap, streamed through one writer with per-container
  format re-selection (``optimise_runs``), so every flushed chunk lands
  through the attributed mutators and the next ``store.packed_for``
  takes the delta path.

Tenant label values resolve through the declared ``TENANTS`` registry;
batch ids and epoch ids are unbounded and live only in the lineage ledger
and decision attributes, never in labels.

Lock discipline: the log lock nests over the metrics-registry lock only.
The depth gauge is set while the lock is held: a submit racing a drain
could otherwise overwrite the drain's ``set(0)`` with its stale depth and
leave the gauge nonzero over an empty log.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from ..observe import registry as _registry
from ..observe.histogram import latency_histogram
from .slo import TENANTS

DEFAULT_MAX_BATCHES = 4096

FRESHNESS = latency_histogram(
    _registry.SERVE_FRESHNESS_SECONDS,
    "Data freshness: ingest->queryable lag per tenant, observed at epoch "
    "publish for every mutation batch the new epoch makes queryable",
    ("tenant",),
)
_INGEST_TOTAL = _registry.counter(
    _registry.SERVE_INGEST_TOTAL,
    "Mutation batches accepted into the ingest log by tenant",
    ("tenant",),
)
_MUTLOG_COUNT = _registry.gauge(
    _registry.SERVE_MUTLOG_COUNT,
    "Mutation batches currently pending in the ingest log (drained to 0 "
    "by each epoch flip — the epoch-flip-stall sentinel rule's gauge)",
)

# process-unique batch ids (atomic under the GIL): lineage and decision
# material, never a metric label value
_BATCH_IDS = itertools.count(1)


class MutationBatch:
    """One stamped mutation batch: ``{bitmap_index: uint32 values}`` from
    one tenant. ``stamp`` is ``time.monotonic()`` at ingest unless
    injected."""

    __slots__ = ("batch_id", "tenant", "mutations", "stamp", "n_values")

    def __init__(self, tenant: str, mutations: Dict[int, np.ndarray],
                 stamp: Optional[float] = None):
        self.batch_id = next(_BATCH_IDS)
        self.tenant = str(tenant)
        self.mutations: Dict[int, np.ndarray] = {}
        n = 0
        for idx, values in mutations.items():
            v = np.asarray(values, dtype=np.int64).ravel()
            if v.size == 0:
                continue
            if v.min() < 0 or v.max() >= 1 << 32:
                raise ValueError(
                    f"batch values for bitmap {idx} outside unsigned 32-bit range"
                )
            self.mutations[int(idx)] = v
            n += int(v.size)
        self.stamp = time.monotonic() if stamp is None else float(stamp)
        self.n_values = n

    def touched(self) -> List[int]:
        return sorted(self.mutations)

    def __repr__(self) -> str:
        return (f"MutationBatch(id={self.batch_id}, tenant={self.tenant!r}, "
                f"bitmaps={self.touched()}, values={self.n_values})")


class IngestLog:
    """Thread-safe bounded mutation log. ``submit`` appends (raising past
    ``max_batches``: backpressure belongs to admission, not silent drops);
    ``drain`` empties it for the flip."""

    def __init__(self, max_batches: int = DEFAULT_MAX_BATCHES):
        if max_batches < 1:
            raise ValueError(f"max_batches must be >= 1, got {max_batches}")
        self.max_batches = int(max_batches)
        # nests over the registry lock only (the depth gauge is set under it)
        self._lock = threading.Lock()
        self._batches: "deque[MutationBatch]" = deque()  # guarded-by: self._lock
        self._total = 0  # guarded-by: self._lock

    def submit(
        self,
        tenant: str,
        mutations: Dict[int, np.ndarray],
        stamp: Optional[float] = None,
    ) -> Optional[MutationBatch]:
        """Append one stamped batch for a declared tenant; returns the
        batch (None for an empty mutation set). The corpus is untouched —
        readers keep serving the current epoch's packs."""
        canon = TENANTS[tenant]
        batch = MutationBatch(canon, mutations, stamp=stamp)
        if not batch.mutations:
            return None
        with self._lock:
            if len(self._batches) >= self.max_batches:
                raise OverflowError(
                    f"ingest log full ({self.max_batches} batches): flip or "
                    "shed before submitting more"
                )
            self._batches.append(batch)
            self._total += 1
            # set under the lock: outside it a racing drain's 0 could be
            # overwritten with this stale depth
            _MUTLOG_COUNT.set(len(self._batches))
        _INGEST_TOTAL.inc(1, (TENANTS[tenant],))
        return batch

    def drain(self) -> List[MutationBatch]:
        """Pop every pending batch (oldest first). Called by the epoch flip
        in its writer-exclusive window; the depth gauge drops to 0."""
        with self._lock:
            batches = list(self._batches)
            self._batches.clear()
            _MUTLOG_COUNT.set(0)
        return batches

    def requeue(self, batches: Sequence[MutationBatch]) -> None:
        """Put drained batches back at the head of the log, oldest first:
        a flip that failed closed returns what it drained. They were
        accepted already, so ``max_batches`` does not refuse them."""
        with self._lock:
            self._batches.extendleft(reversed(list(batches)))
            _MUTLOG_COUNT.set(len(self._batches))

    def depth(self) -> int:
        with self._lock:
            return len(self._batches)

    def pending_values(self) -> int:
        with self._lock:
            return sum(b.n_values for b in self._batches)

    def total(self) -> int:
        """Batches ever accepted (pending + drained)."""
        with self._lock:
            return self._total

    def stamps(self) -> List[float]:
        with self._lock:
            return [b.stamp for b in self._batches]

    def clear(self) -> None:
        with self._lock:
            self._batches.clear()
            self._total = 0
            _MUTLOG_COUNT.set(0)


def merge_batches(batches: Sequence[MutationBatch]) -> Dict[int, np.ndarray]:
    """Coalesce drained batches into one sorted, deduplicated value array
    per touched bitmap index: the flip pays one writer stream per bitmap
    however many batches accumulated."""
    per_bitmap: Dict[int, List[np.ndarray]] = {}
    for b in batches:
        for idx, v in b.mutations.items():
            per_bitmap.setdefault(idx, []).append(v)
    return {
        idx: np.unique(np.concatenate(chunks))
        for idx, chunks in sorted(per_bitmap.items())
    }


def apply_merged(corpus: Sequence, merged: Dict[int, np.ndarray]) -> int:
    """Stream pre-merged per-bitmap values into the corpus through
    ``BitmapWriter(into=...)``, one writer per touched bitmap, with
    per-container format re-selection on the touched keys
    (``optimise_runs``). Runs only inside the flip's writer-exclusive
    window (no readers admitted). Returns the number of touched bitmaps."""
    from ..models.writer import BitmapWriter

    for idx, values in merged.items():
        if not 0 <= idx < len(corpus):
            raise IndexError(
                f"mutation batch touches bitmap {idx} outside the corpus "
                f"(size {len(corpus)})"
            )
        w = BitmapWriter(into=corpus[idx], optimise_runs=True)
        w.add_many(values)
        w.flush()
    return len(merged)


def apply_batches(corpus: Sequence, batches: Sequence[MutationBatch]) -> int:
    """Merge, then apply (the flip merges once itself, because it needs the
    touched set; oracles and tests use this form)."""
    return apply_merged(corpus, merge_batches(batches))


def observe_freshness(
    batches: Iterable[MutationBatch], now: Optional[float] = None
) -> int:
    """Record ingest->queryable lag for every published batch (the flip's
    publish stage). Returns the number of observations."""
    if now is None:
        now = time.monotonic()
    n = 0
    for b in batches:
        FRESHNESS.observe(max(0.0, now - b.stamp), (TENANTS[b.tenant],))
        n += 1
    return n
