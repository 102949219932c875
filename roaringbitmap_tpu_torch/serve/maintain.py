"""Maintenance tier: priced compaction over the live corpus.

Counterpart of ``roaringbitmap_tpu/serve/maintain.py``. The structure
ledger (``observe/structure.py``) sees corpus-shape drift; this module
acts on it. A maintenance pass:

* re-runs format selection over the write-hot keys whose serialized size
  exceeds the size-rule optimum (the ledger's ``drift_targets``:
  ``run_optimize`` per container, never a whole-corpus walk),
* merges the accumulated epoch deltas (the pass rides ``EpochStore.flip``
  with a ``rewrite`` body, so the pending mutation log drains in the same
  writer-exclusive window),
* and refreshes the touched working sets through the pack cache (the
  flip's own working-set refresh, on the device).

**Every pass is a priced decision** (``serve.maintain``,
``cost/compaction.py``): compact-now (the predicted pass wall) against
let-it-ride (the bytes over optimal priced at the declared exchange rate,
scaled by the delta accretion depth). A taken pass joins its measured wall
in the decision–outcome ledger.

A compaction is a flip whose batches are rewrites, so readers keep the old
epoch until publish and never see a half-compacted corpus. Every rewrite
is audited value for value against the container it replaces before it is
installed; a mismatching rewrite is dropped (the old container stays) and
counted as an anomaly — compaction may change representation, never
content.

Fault site ``serve.maintain``: a non-fatal failure at the pass entry fails
CLOSED to the uncompacted epoch — the pass aborts, the corpus keeps
serving the bits it had, the degrade is noted on the ladder, and the
``structure-drift`` / ``delta-accretion`` rules own "drifting too long".
This is the JAX package's semantics, not a device fallback.

The sentinel's ``maintain`` actuation calls :func:`run_pass`.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..cost import compaction as _compaction_cost
from ..observe import decisions as _decisions
from ..observe import outcomes as _outcomes
from ..observe import registry as _registry
from ..observe import structure as _structure
from ..robust import errors as _rerrors
from ..robust import faults as _faults
from ..robust import ladder as _ladder
from . import epochs as _epochs

# pass outcomes (rb_tpu_serve_maintain_total)
PASS_OUTCOMES = ("compacted", "rode", "aborted", "noop")

_MAINTAIN_TOTAL = _registry.counter(
    _registry.SERVE_MAINTAIN_TOTAL,
    "Maintenance passes by outcome (compacted | rode = priced let-it-ride "
    "| aborted = fault/stall, uncompacted epoch kept | noop = nothing "
    "watched)",
    ("outcome",),
)
_MAINTAIN_SECONDS = _registry.histogram(
    _registry.SERVE_MAINTAIN_SECONDS,
    "Wall time of taken maintenance passes (the compaction flip end to "
    "end: drain + rewrite + working-set refresh + publish)",
)
_RECLAIMED_BYTES_TOTAL = _registry.counter(
    _registry.SERVE_MAINTAIN_RECLAIMED_BYTES_TOTAL,
    "Serialized bytes reclaimed by maintenance-pass format re-selection",
)
_KEYS_TOTAL = _registry.counter(
    _registry.SERVE_MAINTAIN_KEYS_TOTAL,
    "Chunk keys rewritten by maintenance passes",
)


def _rewrite_body(
    targets: List[Tuple[object, int, int]], corpus: List
) -> Tuple[callable, Dict]:
    """Build the flip's ``rewrite`` callable over the ledger's drift
    targets. The shared ``stats`` dict is filled in place when the flip
    runs the body (inside the writer-exclusive window)."""
    index_of = {id(bm): i for i, bm in enumerate(corpus)}
    stats: Dict = {
        "rewritten_keys": 0, "reclaimed_bytes": 0,
        "audited": 0, "anomalies": 0,
    }

    def rewrite(live_corpus):
        touched = set()
        for bm, key, _excess in targets:
            idx = index_of.get(id(bm))
            if idx is None:
                continue  # working set no longer part of this corpus
            hlc = bm.high_low_container
            i = hlc.get_index(key)
            if i < 0:
                continue  # key removed since the ledger last looked
            old = hlc.get_container_at_index(i)
            new = old.run_optimize()
            if new is old:
                continue  # already optimal (drifted back before the pass)
            # bit-identity audit: representation may change, content
            # never — a lossy rewrite is dropped (old container stays,
            # fail closed per key) and surfaced as an anomaly
            stats["audited"] += 1
            if new.cardinality != old.cardinality or not np.array_equal(
                new.to_array(), old.to_array()
            ):
                stats["anomalies"] += 1
                continue
            saved = old.serialized_size() - new.serialized_size()
            hlc.set_container_at_index(i, new)
            touched.add(idx)
            stats["rewritten_keys"] += 1
            stats["reclaimed_bytes"] += int(saved)
        return touched, stats

    return rewrite, stats


def run_pass(
    store: Optional["_epochs.EpochStore"] = None,
    reason: str = "manual",
    force: bool = False,
    now: Optional[float] = None,
) -> dict:
    """One priced maintenance pass over the current epoch store's corpus.
    Returns a record whose ``outcome`` is one of :data:`PASS_OUTCOMES`
    (a taken pass also carries the compaction flip's lineage record as
    ``record["flip"]``). ``force=True`` skips the price gate, never the
    fault gate or the identity audit."""
    if store is None:
        store = _epochs.current_store()
    if store is None or not _structure.LEDGER.watched():
        _MAINTAIN_TOTAL.inc(1, ("noop",))
        return {"outcome": "noop", "reason": reason}
    try:
        _faults.fault_point("serve.maintain")
    except Exception as e:
        if _rerrors.classify(e) == _rerrors.FATAL:
            raise
        # fail CLOSED to the uncompacted epoch: the corpus keeps serving
        # exactly the bits it already had; drift keeps accruing and the
        # structure-drift / delta-accretion rules own "too long"
        _ladder.LADDER.note_degrade("serve.maintain", "compact", "ride", e)
        _MAINTAIN_TOTAL.inc(1, ("aborted",))
        _decisions.record_decision(
            "serve.maintain", "aborted", reason=reason,
            error=type(e).__name__,
        )
        return {"outcome": "aborted", "reason": reason,
                "error": type(e).__name__}
    # refresh the books (O(dirty keys)) and price the pass
    stats = _structure.LEDGER.refresh()
    targets = _structure.LEDGER.drift_targets()
    excess = sum(t[2] for t in targets)
    depth = int(stats.get("accretion_depth") or 0)
    log_depth = store.log.depth()
    predicted = _compaction_cost.MODEL.predict_us(
        "compact", keys=len(targets), batches=log_depth,
    )
    ride = _compaction_cost.MODEL.ride_cost_us(excess, depth=depth)
    verdict = "compact" if force or ride >= predicted else "ride"
    seq = _decisions.record_decision(
        "serve.maintain", verdict,
        outcome=(verdict == "compact" and _outcomes.enabled()),
        est_us={"compact": predicted, "ride": ride},
        drift_keys=len(targets), excess_bytes=int(excess),
        accretion_depth=depth, log_batches=log_depth, forced=bool(force),
    )
    if verdict == "ride":
        _MAINTAIN_TOTAL.inc(1, ("rode",))
        return {
            "outcome": "rode", "reason": reason,
            "drift_keys": len(targets), "excess_bytes": int(excess),
            "est_us": {"compact": predicted, "ride": ride},
        }
    rewrite, rw_stats = _rewrite_body(targets, store.corpus)
    t0 = time.perf_counter()
    flip = store.flip(reason=f"maintain:{reason}", now=now, rewrite=rewrite)
    wall_s = time.perf_counter() - t0
    if flip["outcome"] != "flipped":
        # the flip failed closed (its own fault gate, or a reader-drain
        # stall): the uncompacted epoch stands, nothing was rewritten
        _MAINTAIN_TOTAL.inc(1, ("aborted",))
        return {"outcome": "aborted", "reason": reason, "flip": flip}
    if seq is not None:
        _outcomes.resolve(seq, "serve.maintain", wall_s, engine="compact")
    _MAINTAIN_TOTAL.inc(1, ("compacted",))
    _MAINTAIN_SECONDS.observe(wall_s)
    if rw_stats["reclaimed_bytes"] > 0:
        _RECLAIMED_BYTES_TOTAL.inc(rw_stats["reclaimed_bytes"])
    if rw_stats["rewritten_keys"] > 0:
        _KEYS_TOTAL.inc(rw_stats["rewritten_keys"])
    # the accumulated deltas are merged and the shape rewritten: settle
    # the accretion depth and re-export the gauges from the fresh books
    _structure.LEDGER.settle_accretion()
    _structure.LEDGER.refresh()
    record = {
        "outcome": "compacted", "reason": reason, "wall_s": round(wall_s, 6),
        "flip": flip, **rw_stats,
        "est_us": {"compact": predicted, "ride": ride},
    }
    _LAST.update(record)
    return record


# the last taken pass (the insights structure panel's feed);
# plain dict, read-copied by callers
_LAST: Dict = {}


def last_pass() -> dict:
    """The most recent compacted pass's record ({} before any)."""
    return dict(_LAST)


def reset() -> None:
    """Forget the last-pass record (test isolation)."""
    _LAST.clear()
