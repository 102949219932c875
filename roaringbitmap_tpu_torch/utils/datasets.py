"""Real-roaring-dataset loader.

Mirrors the reference harness corpus access
(ZipRealDataRetriever.fetchBitPositions,
real-roaring-dataset/.../ZipRealDataRetriever.java:39-69): each zip entry is
one CSV line of sorted ints = the bit positions of one bitmap.

When no dataset directory is given, or it lacks the named corpus, a seeded
synthetic corpus with a census1881-like shape profile is generated instead
so benchmarks stay runnable anywhere.
"""

from __future__ import annotations

import io
import os
import zipfile
from typing import List, Optional

import numpy as np


def dataset_available(name: str, dataset_dir: Optional[str]) -> bool:
    return dataset_dir is not None and os.path.isfile(
        os.path.join(dataset_dir, name + ".zip")
    )


def fetch_bit_positions(name: str, dataset_dir: str) -> List[np.ndarray]:
    """All bitmaps of a corpus as uint32 arrays (one per zip entry)."""
    path = os.path.join(dataset_dir, name + ".zip")
    out: List[np.ndarray] = []
    with zipfile.ZipFile(path) as zf:
        for entry in sorted(zf.namelist()):
            with zf.open(entry) as f:
                text = io.TextIOWrapper(f, encoding="ascii").read()
            vals = np.array(
                [int(tok) for tok in text.replace("\n", "").split(",") if tok.strip()],
                dtype=np.int64,
            )
            out.append(vals.astype(np.uint32))
    return out


def synthetic_census_like(
    n_bitmaps: int = 200, seed: int = 0xFEEF1F0
) -> List[np.ndarray]:
    """Synthetic corpus with census1881-ish shape: clustered runs + sparse
    scatter over a few million values."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_bitmaps):
        parts = []
        n_clusters = int(rng.integers(1, 30))
        for _ in range(n_clusters):
            base = int(rng.integers(0, 2_000_000))
            length = int(rng.integers(1, 2000))
            parts.append(np.arange(base, base + length, dtype=np.int64))
        scatter = rng.integers(0, 2_000_000, size=int(rng.integers(10, 3000)))
        parts.append(scatter)
        out.append(np.unique(np.concatenate(parts)).astype(np.uint32))
    return out


def load_or_synthesize(
    name: str = "census1881",
    n_bitmaps_hint: int = 200,
    dataset_dir: Optional[str] = None,
):
    """Corpus bitmaps (uint32 arrays) and whether they are the real
    dataset: the named corpus from ``dataset_dir`` when it is there, else
    the seeded synthetic one."""
    if dataset_available(name, dataset_dir):
        return fetch_bit_positions(name, dataset_dir), True
    return synthetic_census_like(n_bitmaps_hint), False
