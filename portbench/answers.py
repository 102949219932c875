"""How an answer is compared with the reference's: a set by its bits, a
count exactly.

The reference gives a set as uint64 ``[K, 1024]`` words, bit b of word w
of row k standing for value ``65536 k + 64 w + b``; the port's bitmap is
read back from its portable bytes (``serialize``) with the benchmark's own
reader, so every container the port built is judged."""

from __future__ import annotations

import numpy as np
import torch

from . import wire


def mask_words(mask: torch.Tensor) -> np.ndarray:
    """A bool ``[n]`` membership mask (on any device) as set words."""
    n = mask.numel()
    k = -(-n // wire.CHUNK)
    bits = torch.zeros(k * wire.CHUNK, dtype=torch.int64, device=mask.device)
    bits[:n] = mask.to(torch.int64)
    w = torch.ones(1, dtype=torch.int64, device=mask.device) << torch.arange(64, device=mask.device)
    words = (bits.view(k * 1024, 64) * w).sum(dim=1)
    return words.cpu().numpy().view(np.uint64).reshape(k, 1024)


def _is_set(x) -> bool:
    return isinstance(x, np.ndarray) and x.ndim == 2 and x.dtype == np.uint64


def off_by(expected, got) -> int:
    """0 when ``got`` is ``expected``; else how far it is off: the values
    in one set and not the other, the summed gaps of the counts, or the gap
    of one count (at least 1 whenever the kinds differ)."""
    if _is_set(expected):
        if hasattr(got, "serialize"):
            words, outside = wire.read_words(got.serialize(), expected.shape[0])
        elif _is_set(got) and got.shape == expected.shape:
            words, outside = got, 0
        else:
            return max(1, int(np.bitwise_count(expected).sum()))
        return int(np.bitwise_count(words ^ expected).sum()) + outside
    if isinstance(expected, np.ndarray):
        got = np.asarray(got) if not hasattr(got, "serialize") else None
        if got is None or got.shape != expected.shape:
            return max(1, int(np.abs(expected).sum()))
        return int(np.abs(got.astype(np.int64) - expected.astype(np.int64)).sum())
    if hasattr(got, "serialize") or isinstance(got, np.ndarray):
        return max(1, abs(int(expected)))
    return abs(int(got) - int(expected))
