"""The ``device`` argument of the entry points.

Every device-path entry point takes ``device=`` (default ``"cuda"``, see
``parallel.aggregation.config.device``). It is resolved here and nowhere
else: ``"cuda"`` (or ``"cuda:N"``) on a host without a usable card raises
:class:`~.robust.errors.TierUnavailable` — the port never swaps in the CPU
behind the caller's back. ``"cpu"`` runs the same device-path code on CPU
tensors, where each kernel wrapper uses its kernel's plain PyTorch version
(that is how the tests run it).
"""

from __future__ import annotations

from typing import Union

import torch

from .robust.errors import TierUnavailable

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """Validate ``device`` and return it as a ``torch.device``."""
    d = torch.device(DEFAULT_DEVICE if device is None else device)
    if d.type == "cpu":
        return d
    if d.type != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if not torch.cuda.is_available():
        raise TierUnavailable(
            f"device {str(d)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the device path on CPU tensors"
        )
    if d.index is not None and d.index >= torch.cuda.device_count():
        raise TierUnavailable(
            f"device {str(d)!r} requested but only "
            f"{torch.cuda.device_count()} CUDA device(s) are visible"
        )
    return d
