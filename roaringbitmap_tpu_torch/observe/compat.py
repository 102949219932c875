"""Mapping views over registry counters: the module counters the port kept
as plain dicts before the registry (``ops/kernels.LAUNCHES``,
``parallel/store.LAYOUT_COUNTS``, ``parallel/store.TRANSFER_BYTES``) keep
their mapping interface while every value lives in a labeled registry
``Counter``, so direct readers see the dict shapes they always saw and
the registry exporters see the same numbers under their canonical metric
names.

Counterpart of ``roaringbitmap_tpu/observe/compat.py``. One addition:
``fixed=`` pins some of the metric's labels, so a view can show one slice
of a wider metric — ``LAUNCHES`` is ``rb_tpu_kernel_dispatch_total`` with
``engine="cuda"``, keyed by the kernel name alone.

Writers inside this package go through ``Counter.inc`` (atomic under the
registry lock); ``CounterMap.__setitem__`` exists so code that does
``COUNTS[key] += 1`` or zeroes a key keeps working (that read-modify-write
is as racy as the dict it replaces)."""

from __future__ import annotations

from collections.abc import MutableMapping
from typing import Dict, Iterator, Optional, Tuple, Union

from .registry import Counter

Key = Union[str, Tuple[str, ...]]


class CounterMap(MutableMapping):
    """``collections.Counter``-compatible view over one labeled registry
    Counter. ``scalar=True`` maps bare-string keys onto the one label left
    free; otherwise keys are tuples aligned with the free labels.
    ``fixed`` maps label names to the values this view is pinned to."""

    def __init__(self, metric: Counter, scalar: bool = False,
                 fixed: Optional[Dict[str, str]] = None):
        fixed = dict(fixed or {})
        unknown = set(fixed) - set(metric.labelnames)
        if unknown:
            raise ValueError(f"{metric.name} has no label(s) {sorted(unknown)}")
        free = [i for i, n in enumerate(metric.labelnames) if n not in fixed]
        if scalar and len(free) != 1:
            raise ValueError(
                f"scalar CounterMap needs one free label, "
                f"{metric.name} has {metric.labelnames} with {sorted(fixed)} fixed"
            )
        self._metric = metric
        self._scalar = scalar
        self._free = free
        self._fixed = tuple(
            (i, str(fixed[n])) for i, n in enumerate(metric.labelnames) if n in fixed
        )

    @property
    def metric(self) -> Counter:
        return self._metric

    def _lv(self, key: Key) -> Tuple[str, ...]:
        vals = [str(key)] if self._scalar else [str(k) for k in key]
        if len(vals) != len(self._free):
            raise TypeError(f"{self._metric.name}: key {key!r} does not name the free labels")
        lv = [""] * len(self._metric.labelnames)
        for i, v in zip(self._free, vals):
            lv[i] = v
        for i, v in self._fixed:
            lv[i] = v
        return tuple(lv)

    def _key(self, lv: Tuple[str, ...]) -> Key:
        free = tuple(lv[i] for i in self._free)
        return free[0] if self._scalar else free

    def _mine(self, lv: Tuple[str, ...]) -> bool:
        return all(lv[i] == v for i, v in self._fixed)

    def __getitem__(self, key: Key):
        # Counter semantics: a missing key reads as 0 and is not created
        return self._metric.get(self._lv(key))

    def __setitem__(self, key: Key, value) -> None:
        self._metric.set(value, self._lv(key))

    def __delitem__(self, key: Key) -> None:
        self._metric.remove(self._lv(key))

    def __contains__(self, key) -> bool:
        try:
            lv = self._lv(key)
        except TypeError:
            return False
        return lv in self._metric.series()

    def _series(self):
        return [(lv, v) for lv, v in self._metric.series().items() if self._mine(lv)]

    def __iter__(self) -> Iterator[Key]:
        return iter([self._key(lv) for lv, _ in self._series()])

    def __len__(self) -> int:
        return len(self._series())

    def items(self):
        return [(self._key(lv), v) for lv, v in self._series()]

    def clear(self) -> None:
        if not self._fixed:
            self._metric.clear()
            return
        for lv, _ in self._series():
            self._metric.remove(lv)

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"CounterMap({self._metric.name}, {dict(self.items())!r})"
