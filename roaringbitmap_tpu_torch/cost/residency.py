"""Pack residency pricing authority: the learned re-pack cost of an
eviction.

Counterpart of ``roaringbitmap_tpu/cost/residency.py``, with the same
schema, EWMAs and idempotence. ``PACK_CACHE``'s byte-budget LRU decides
what stays resident on the card; the marshal path pays a measured ship
cost per row (``columnar.MODEL.ship_us_per_row``, the coefficient this
authority exposes rather than re-measuring); and an eviction's true price
is the re-pack wall paid when the working set comes back: a re-pack of a
remembered eviction joins the evict decision with its wall as regret
(the outcome ledger's ``pack_cache.evict`` site).

This model turns those joins into a per-kind geometric EWMA of the
measured re-pack cost (``repack_s``), which the pack cache records as
the next eviction's ``est_us`` (``parallel/store.py``), so the evict
join scores this authority like the others. The ``readmit_s`` curve (the
mapped rung's re-admit cost, learned from ``durable.readmit`` joins) is
kept for the state's schema; nothing in the port records that site until
the durable tier comes.

The backend stamp is the device type the device tier runs on
(``"cuda"`` / ``"cpu"``, ``columnar/costmodel._backend``): re-pack walls
measured on the card are refused on a host, and the reverse.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional

SCHEMA = "rb_tpu_cost_residency/1"
# EWMA weight for the per-kind repack cost: evictions are rare events, so
# adapt faster than the per-join drift EWMA (~8-sample memory)
_ALPHA = 0.25


class ResidencyModel:
    """Per-kind measured re-pack cost EWMAs + the shared ship pricing."""

    def __init__(self):
        self._lock = threading.Lock()
        self.repack_s: Dict[str, float] = {}  # guarded-by: self._lock
        self.readmit_s: Dict[str, float] = {}  # guarded-by: self._lock
        self.samples: Dict[str, int] = {}  # guarded-by: self._lock
        self.provenance = "static"  # guarded-by: self._lock
        self.backend: Optional[str] = None  # guarded-by: self._lock
        # highest decision serial already folded into the EWMAs: the
        # sentinel re-runs refit_all every cooldown against the SAME
        # retained ledger tail, and re-folding consumed joins would walk
        # the EWMA and double-count samples on every pass (idempotence:
        # a refit over an unchanged ledger is a no-op)
        self._seen_seq = 0  # guarded-by: self._lock

    def curves_view(self) -> dict:
        from ..columnar import costmodel as _costmodel

        with self._lock:
            repack = {k: round(v, 6) for k, v in sorted(self.repack_s.items())}
            readmit = {
                k: round(v, 6) for k, v in sorted(self.readmit_s.items())
            }
        view = {
            # the ship coefficient is SHARED with the columnar calibration
            # (one curve, two consumers), not a second measurement that
            # could disagree
            "ship_us_per_row": _costmodel.MODEL.ship_us_per_row,
            "repack_s": repack,
            "readmit_s": readmit,
        }
        try:
            from ..parallel import store as _store

            view["budget_bytes"] = _store.PACK_CACHE.max_bytes
        except Exception:  # rb-ok: exception-hygiene -- a curves read must not fail because the cache is mid-teardown; the pricing curves above are still valid
            pass
        return view

    def repack_estimate(self, kind: str) -> Optional[float]:
        """The learned re-pack cost (seconds) for one cache kind — what
        the pack cache prices an eviction of that kind at (None until
        evict-regret traffic has taught the curve). The evict decision
        records it as ``est_us`` so the ledger join scores the residency
        authority's pricing like the other authorities'."""
        with self._lock:
            return self.repack_s.get(kind)

    def readmit_estimate(self, kind: str) -> Optional[float]:
        """The learned mmap re-admit cost (seconds) for one cache kind —
        the cheaper return path a mapped-rung demotion prices against
        the cold ``repack_estimate`` (None until ``durable.readmit``
        traffic has taught the curve)."""
        with self._lock:
            return self.readmit_s.get(kind)

    def drift(self) -> Dict[str, float]:
        """Latest-sample vs EWMA ratio per kind — a kind whose newest
        measured re-pack sits far off its learned curve is drifting."""
        latest: Dict[str, float] = {}
        for e in _evict_samples():
            kind = (e.get("inputs") or {}).get("kind")
            if kind and e.get("measured_s"):
                latest[str(kind)] = float(e["measured_s"])  # newest wins
        with self._lock:
            ewma = dict(self.repack_s)
        out = {}
        for kind, s in sorted(latest.items()):
            base = ewma.get(kind)
            if base and base > 0 and s > 0:
                out[kind] = round(s / base, 4)
        return out

    def refit_from_outcomes(
        self, samples: Optional[List[dict]] = None, min_samples: int = 1
    ) -> dict:
        """Fold joined evict-regret samples into the per-kind EWMAs.
        Ledger-sourced samples (carrying a decision ``seq``) are consumed
        AT MOST ONCE across calls — re-refitting an unchanged ledger is a
        no-op; explicit caller-owned sample lists without serials are
        folded as given. Returns the facade-shape report."""
        moved: Dict[str, dict] = {}
        rejected = 0
        by_kind: Dict[str, List[float]] = {}
        readmit_by_kind: Dict[str, List[float]] = {}
        with self._lock:
            seen = self._seen_seq
        max_seq = seen
        for e in _ledger_samples(samples):
            if e.get("site") == "durable.readmit":
                pool = readmit_by_kind
            else:
                pool = by_kind
            seq = e.get("seq")
            if seq is not None:
                if seq <= seen:
                    continue  # already folded by an earlier refit
                max_seq = max(max_seq, seq)
            kind = (e.get("inputs") or {}).get("kind")
            s = e.get("measured_s")
            if kind is None or s is None:
                rejected += 1
                continue
            s = float(s)
            if not math.isfinite(s) or s <= 0:
                rejected += 1
                continue
            pool.setdefault(str(kind), []).append(s)
        with self._lock:
            self._seen_seq = max(self._seen_seq, max_seq)
            for curve, pool, label in (
                (self.repack_s, by_kind, ""),
                (self.readmit_s, readmit_by_kind, "readmit:"),
            ):
                for kind, ss in sorted(pool.items()):
                    if len(ss) < min_samples:
                        continue
                    old = curve.get(kind)
                    cur = old
                    for s in ss:
                        if cur is None or cur <= 0:
                            cur = s
                        else:
                            cur = math.exp(
                                (1 - _ALPHA) * math.log(cur)
                                + _ALPHA * math.log(s)
                            )
                    cur = round(cur, 9)
                    key = label + kind
                    self.samples[key] = self.samples.get(key, 0) + len(ss)
                    if cur != old:
                        curve[kind] = cur
                        moved[key] = {
                            "from": old, "to": cur, "samples": len(ss)
                        }
            if moved:
                self.provenance = "refit-from-traffic"
                self.backend = _current_backend()
            prov = self.provenance
        return {"moved": moved, "rejected": rejected, "provenance": prov,
                "samples": sum(len(s) for s in by_kind.values())
                + sum(len(s) for s in readmit_by_kind.values())}

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "schema": SCHEMA,
                "backend": self.backend,
                "repack_s": {k: v for k, v in sorted(self.repack_s.items())},
                "readmit_s": {k: v for k, v in sorted(self.readmit_s.items())},
                "samples": dict(self.samples),
                "provenance": self.provenance,
            }

    def from_dict(self, d: dict) -> bool:
        if not isinstance(d, dict) or d.get("schema") != SCHEMA:
            return False
        # re-pack walls are per-host measurements: a state measured on a
        # different backend must not price this host's evictions (the
        # columnar model's per-backend discipline)
        if d.get("backend") is not None and d["backend"] != _current_backend():
            return False
        repack = d.get("repack_s")
        if not isinstance(repack, dict):
            return False
        clean: Dict[str, float] = {}
        for kind, v in repack.items():
            try:
                v = float(v)
            except (TypeError, ValueError):
                return False
            if not (math.isfinite(v) and v > 0):
                return False
            clean[str(kind)] = v
        # readmit_s is absent from states saved before the mapped rung — an
        # empty curve, not a schema break
        clean_readmit: Dict[str, float] = {}
        for kind, v in (d.get("readmit_s") or {}).items():
            try:
                v = float(v)
            except (TypeError, ValueError):
                return False
            if not (math.isfinite(v) and v > 0):
                return False
            clean_readmit[str(kind)] = v
        with self._lock:
            self.repack_s = clean
            self.readmit_s = clean_readmit
            self.samples = {
                str(k): int(v) for k, v in (d.get("samples") or {}).items()
            }
            self.provenance = str(d.get("provenance") or "static")
            self.backend = d.get("backend")
        return True

    def reset(self) -> None:
        with self._lock:
            self.repack_s = {}
            self.readmit_s = {}
            self.samples = {}
            self.provenance = "static"
            self.backend = None
            self._seen_seq = 0


def _current_backend() -> str:
    """The device type the device tier runs on (``"cuda"`` / ``"cpu"``)."""
    from ..columnar import costmodel as _costmodel

    return _costmodel._backend()


def _evict_samples(samples: Optional[List[dict]] = None) -> List[dict]:
    if samples is not None:
        return list(samples)
    from ..observe import outcomes as _outcomes

    return [e for e in _outcomes.tail() if e.get("site") == "pack_cache.evict"]


def _ledger_samples(samples: Optional[List[dict]] = None) -> List[dict]:
    """Both curves' joined samples: evict-regret AND mmap re-admits."""
    if samples is not None:
        return list(samples)
    from ..observe import outcomes as _outcomes

    return [
        e for e in _outcomes.tail()
        if e.get("site") in ("pack_cache.evict", "durable.readmit")
    ]


MODEL = ResidencyModel()
