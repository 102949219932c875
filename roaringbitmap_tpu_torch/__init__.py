"""roaringbitmap_tpu_torch — the Roaring bitmap framework on PyTorch and CUDA.

The port of ``roaringbitmap_tpu`` (JAX on a TPU) to an NVIDIA H100: the same
containers, facade, serialization format, N-way aggregation engines with
the resident pack cache, the bit-sliced index with ``RangeBitmap``, the
query planner, executor and fusion window (``roaringbitmap_tpu_torch.query``),
the overlap shipping lane (``parallel/overlap.py``, ``run_pipelined``), the
columnar pairwise engine (``roaringbitmap_tpu_torch.columnar``), batch
similarity (``parallel/batch.py``: one-vs-many masked counts and the
all-pairs overlap matrices), and the buffer package: memory-mapped
``ImmutableRoaringBitmap``s and ``ImmutableBitSliceIndex``es queried
without a parse, ``MutableRoaringBitmap``, ``BufferFastAggregation`` /
``BufferParallelAggregation``, with the iterators, writers, ``RoaringBitSet``,
``FastRankRoaringBitmap`` and ``insights``; and the 64-bit family:
``Roaring64Bitmap`` over its adaptive radix tree (``Art``),
``Roaring64NavigableMap``, ``FastAggregation64`` and
``Roaring64BitmapSliceIndex``; and multi-device sharding over a
``torch.distributed`` mesh (``parallel/sharding.py``, reached through the
``mesh`` knob of the aggregation, BSI and 64-bit BSI configs); and the
instrumentation: the metrics registry, flight-recorder timeline, trace
ids, decision log and outcome ledger (``observe``), fault injection and
the tier ladder with retries, breakers and deadlines (``robust``), and
``torch.profiler`` windows and host-phase timers (``tracing``); the cost
authorities (``cost``); the serving tier (``serve``: tenants, admission,
the load harness, the ingest log, epoch flips and maintenance passes) and
the durable tier (``durable``: atomic epoch persists, crash recovery and
the mapped corpus); with the device path in PyTorch and its kernels written by hand in CUDA
(``csrc/``). It imports neither JAX nor
the JAX package; that package stays the reference the port is tested
against.

Device entry points run on the card (``device="cuda"``) unless the caller
passes ``device="cpu"``; a missing card raises instead of falling back.
"""

from .models.art import Art
from .models.bitset import RoaringBitSet
from .models.bsi import Operation, ResidentSet, RoaringBitmapSliceIndex
from .models.bsi64 import Roaring64BitmapSliceIndex
from .models.bsi_buffer import ImmutableBitSliceIndex, MutableBitSliceIndex
from .models.buffer import BufferFastAggregation, BufferParallelAggregation, MutableRoaringBitmap
from .models.container import (
    ArrayContainer,
    BitmapContainer,
    RunContainer,
    container_from_values,
    container_range_of_ones,
)
from .models.fastrank import FastRankRoaringBitmap
from .models.immutable import ImmutableRoaringBitmap
from .models.iterators import (
    BatchIntIterator,
    PeekableIntIterator,
    PeekableIntRankIterator,
    ReverseIntIterator,
    RoaringBatchIterator,
)
from .models.range_bitmap import RangeBitmap
from .models.roaring import RoaringBitmap
from .models.roaring64 import Roaring64NavigableMap
from .models.roaring64art import Roaring64Bitmap
from .models.writer import RoaringBitmapWriter
from .parallel.aggregation import FastAggregation, ParallelAggregation
from .parallel.aggregation64 import FastAggregation64
from .parallel.batch import (
    batched_cardinality,
    batched_intersects,
    batched_op,
    pairwise_and_cardinality,
    pairwise_cardinality,
    pairwise_jaccard,
    prepare_batched_cardinality,
)
from .parallel.overlap import run_pipelined
from .parallel import sharding
from .serialization import InvalidRoaringFormat
from . import observe
from . import robust
from . import tracing
from . import insights
from . import query
from .query import Q

__all__ = [
    "ArrayContainer",
    "BitmapContainer",
    "RunContainer",
    "container_from_values",
    "container_range_of_ones",
    "RoaringBitmap",
    "MutableRoaringBitmap",
    "Roaring64Bitmap",
    "Roaring64NavigableMap",
    "Art",
    "ImmutableRoaringBitmap",
    "RoaringBitSet",
    "FastRankRoaringBitmap",
    "RoaringBitmapWriter",
    "FastAggregation",
    "FastAggregation64",
    "ParallelAggregation",
    "BufferFastAggregation",
    "BufferParallelAggregation",
    "RoaringBitmapSliceIndex",
    "ResidentSet",
    "Roaring64BitmapSliceIndex",
    "MutableBitSliceIndex",
    "ImmutableBitSliceIndex",
    "Operation",
    "RangeBitmap",
    "InvalidRoaringFormat",
    "PeekableIntIterator",
    "PeekableIntRankIterator",
    "ReverseIntIterator",
    "RoaringBatchIterator",
    "BatchIntIterator",
    "insights",
    "observe",
    "tracing",
    "run_pipelined",
    "batched_cardinality",
    "batched_intersects",
    "batched_op",
    "pairwise_and_cardinality",
    "pairwise_cardinality",
    "pairwise_jaccard",
    "prepare_batched_cardinality",
    "query",
    "Q",
    "sharding",
]
