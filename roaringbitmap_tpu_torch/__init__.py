"""roaringbitmap_tpu_torch — the Roaring bitmap framework on PyTorch and CUDA.

The port of ``roaringbitmap_tpu`` (JAX on a TPU) to an NVIDIA H100: the same
containers, facade, serialization format and N-way aggregation engines,
with the device path in PyTorch and its kernels written by hand in CUDA
(``csrc/``). It imports neither JAX nor the JAX package; that package stays
the reference the port is tested against.

Device entry points run on the card (``device="cuda"``) unless the caller
passes ``device="cpu"``; a missing card raises instead of falling back.
"""

from .models.roaring import RoaringBitmap
from .parallel.aggregation import FastAggregation, ParallelAggregation

__all__ = ["RoaringBitmap", "FastAggregation", "ParallelAggregation"]
