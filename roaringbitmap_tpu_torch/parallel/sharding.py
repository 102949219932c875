"""Multi-device distribution: container-axis sharding over a device mesh,
on ``torch.distributed``.

Counterpart of the JAX package's ``parallel/sharding.py``. The mesh is a
2D ``DeviceMesh`` with the dimensions ``("containers", "words")``:

* ``containers`` — bitmaps, containers or key chunks data-parallel across
  ranks. The cross-rank combine of an OR, AND or XOR is an all-gather of
  the per-rank partials followed by a local fold: NCCL has no bitwise
  reduction (``ReduceOp.BOR`` and its kin exist only under gloo), and it is
  the collective the JAX programs issue too.
* ``words`` — the 2048-word row split model-parallel, so each rank holds
  rows of ``2048 / nw`` words. The word fold needs no traffic; counts
  finish with one int32 SUM all-reduce over ``words``.

One controller against many. JAX runs one controller over a global array
and ``shard_map`` cuts it. Here every rank runs the same program on its own
shard: each program below takes this rank's block and returns this rank's
part of the JAX program's ``out_specs``, and every rank of the mesh must
call it. :func:`shard_rows` cuts a replicated array into this rank's block
(what ``jnp.asarray`` plus ``shard_map`` do in JAX) and
:func:`gather_shards` assembles a sharded result on every rank.

Every program's local part runs on a hand-written kernel of
``ops/kernels.py`` at the rank's row width (``kernels.ROW_WIDTHS``):
``rb_group_reduce`` and ``rb_popcount_rows`` for the reductions, the
masked ``rb_popcount_rows`` for the BSI sum, ``rb_oneil_compare`` and
``rb_oneil_counts`` for the BSI walks. The collectives are the same under
gloo and NCCL: one all-gather over ``containers`` and one all-reduce over
``words`` for a reduction, one all-reduce for a BSI program.
:func:`collective_summary` counts them under the JAX names.

Under gloo a CUDA tensor is copied to host memory for the collective and
back (``_on_wire``): the gloo world is the one a single card can hold
several ranks of, and what it checks is the programs, not the link. The
local kernels stay on the card. NCCL carries CUDA tensors as they are.

No fallback: a mesh whose ranks cannot reach each other raises, a failed
collective propagates, and nothing drops to the unsharded path because a
world could not be formed.
"""

from __future__ import annotations

import datetime
import functools
import os
import threading
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..ops import kernels

AXES = ("containers", "words")


def initialize_multihost(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    timeout: Optional[float] = None,
) -> int:
    """Join the process group and return the world size.

    With ``init_method`` (``"tcp://host:port"``), ``world_size`` and
    ``rank`` it wraps ``init_process_group``; a configuration that fails
    raises (a configured world must never shrink into a wrong-answer world
    of one). With no arguments it reads a ``torchrun`` environment
    (``env://``) where there is one, and otherwise forms a world of 1 over
    a local store. ``backend`` None is torch's default (gloo for CPU
    tensors, NCCL for CUDA tensors where torch has it); ``timeout`` is in
    seconds. Safe when the group is already initialized: the world size is
    returned, and a ``world_size`` or ``rank`` that disagrees raises."""
    if dist.is_initialized():
        if world_size is not None and world_size != dist.get_world_size():
            raise RuntimeError(
                f"process group already initialized with world size "
                f"{dist.get_world_size()}, not {world_size}"
            )
        if rank is not None and rank != dist.get_rank():
            raise RuntimeError(f"process group already initialized as rank {dist.get_rank()}, not {rank}")
        return dist.get_world_size()
    kwargs = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    if init_method is not None or world_size is not None or rank is not None:
        dist.init_process_group(
            backend, init_method=init_method,
            world_size=-1 if world_size is None else world_size,
            rank=-1 if rank is None else rank, **kwargs,
        )
    elif all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")):
        dist.init_process_group(backend, init_method="env://", **kwargs)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **kwargs)
    return dist.get_world_size()


def make_mesh(n_devices: Optional[int] = None, words_axis: int = 2, device_type: str = "cuda"):
    """2D ``DeviceMesh`` over the whole world, dimensions ``("containers",
    "words")``; ``words_axis`` shrinks until it divides the world
    (``words_axis=1`` is pure data parallelism). Joins a world of 1 when no
    process group exists (:func:`initialize_multihost`). ``n_devices``, if
    given, must be the world size. ``device_type`` is ``"cuda"`` (each
    rank's current card; a host without one raises ``TierUnavailable``) or
    ``"cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh

    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    if device_type == "cuda":
        resolve_device("cuda")
    n = initialize_multihost()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a mesh spans the whole world: {n} ranks, not {n_devices}")
    while words_axis > 1 and n % words_axis:
        words_axis -= 1
    return init_device_mesh(device_type, (n // words_axis, words_axis), mesh_dim_names=AXES)


def mesh_device(mesh) -> torch.device:
    """The device this rank's shards live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def axis_size(mesh, axis: str) -> int:
    return int(mesh.mesh.shape[AXES.index(axis)])


# ---------------------------------------------------------------------------
# collectives, recorded under the JAX names
# ---------------------------------------------------------------------------


class _Recorder(threading.local):
    records: Optional[list] = None


_REC = _Recorder()


def _record(op: str, mesh, axis: str) -> None:
    if _REC.records is not None:
        ranks = mesh.mesh.movedim(AXES.index(axis), -1).reshape(-1, axis_size(mesh, axis))
        _REC.records.append({"op": op, "axis": axis, "replica_groups": ranks.tolist()})


def _on_wire(t: torch.Tensor, group) -> torch.Tensor:
    """The tensor a collective of ``group`` sends: ``t`` itself, or under a
    backend without NCCL a host copy of a CUDA tensor (gloo's collectives
    are run on host memory here, explicitly, whatever its CUDA support)."""
    if t.is_cuda and "nccl" not in str(dist.get_backend(group)):
        return t.cpu()
    return t.contiguous()


def _all_gather(mesh, axis: str, t: torch.Tensor) -> torch.Tensor:
    """``[n, *t.shape]``: every rank's ``t`` along ``axis``, in mesh order."""
    group = mesh.get_group(axis)
    src = _on_wire(t, group)
    parts = [torch.empty_like(src) for _ in range(axis_size(mesh, axis))]
    _record("all-gather", mesh, axis)
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts).to(t.device)


def _all_reduce_sum(mesh, axis: str, t: torch.Tensor) -> torch.Tensor:
    """The SUM of ``t`` over ``axis``, in place on ``t``."""
    group = mesh.get_group(axis)
    wire = _on_wire(t, group)
    _record("all-reduce", mesh, axis)
    dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=group)
    if wire is not t:
        t.copy_(wire)
    return t


def collective_details(step, *args) -> list:
    """Run ``step(*args)`` once (on every rank, as any program runs) and
    return one record per collective it issued: ``{"op", "axis",
    "replica_groups"}``, the ranks of each group along the axis in mesh
    order. The counterpart of the JAX package's reader of compiled HLO
    text."""
    prev, _REC.records = _REC.records, []
    try:
        step(*args)
        return _REC.records
    finally:
        _REC.records = prev


def collective_summary(step, *args) -> dict:
    """Count the collectives ``step(*args)`` issues, by the JAX names
    (``"all-gather"``, ``"all-reduce"``, ...)."""
    counts: dict = {}
    for c in collective_details(step, *args):
        counts[c["op"]] = counts.get(c["op"], 0) + 1
    return counts


# ---------------------------------------------------------------------------
# shards
# ---------------------------------------------------------------------------


def _as_tensor(array) -> torch.Tensor:
    """A torch tensor of ``array``; uint32 words become their int32 bits."""
    if isinstance(array, torch.Tensor):
        return array
    a = np.asarray(array)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a))


def shard_rows(mesh, array, spec: Sequence[Optional[str]]) -> torch.Tensor:
    """This rank's block of a replicated ``array`` (numpy or torch, uint32
    words as int32 bits) on the mesh's device: dimension d is cut evenly
    over the mesh axis ``spec[d]`` (``"containers"``, ``"words"`` or None
    for replicated), as a ``PartitionSpec`` cuts it in JAX. A dimension
    that the axis does not divide raises."""
    t = _as_tensor(array)
    if len(spec) != t.dim():
        raise ValueError(f"spec {tuple(spec)} does not match shape {tuple(t.shape)}")
    coord = mesh.get_coordinate()
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        n = axis_size(mesh, axis)
        if t.shape[d] % n:
            raise ValueError(f"dimension {d} ({t.shape[d]}) does not divide over {axis!r} ({n})")
        b = t.shape[d] // n
        t = t.narrow(d, coord[AXES.index(axis)] * b, b)
    return t.contiguous().to(mesh_device(mesh))


def gather_shards(mesh, local: torch.Tensor, spec: Sequence[Optional[str]]) -> torch.Tensor:
    """The whole of a result sharded by ``spec`` (this rank's ``local``
    block), on every rank: one all-gather along each sharded dimension's
    axis of more than one rank (on an axis of one the block is the
    whole)."""
    if len(spec) != local.dim():
        raise ValueError(f"spec {tuple(spec)} does not match shape {tuple(local.shape)}")
    out = local
    for d, axis in enumerate(spec):
        if axis is not None and axis_size(mesh, axis) > 1:
            out = torch.cat(_all_gather(mesh, axis, out).unbind(0), dim=d)
    return out


@functools.lru_cache(maxsize=64)
def _dense_plan(g: int, m: int) -> kernels.SegmentPlan:
    """G segments of M rows, kept so its chunk table stays on the device."""
    return kernels.SegmentPlan.dense(g, m)


def _walk_bits(bits, q_n: int, walks: int, s_count: int, device) -> torch.Tensor:
    """Predicate bits (high slice first; bool or int, numpy or torch) as
    the int32 ``[Q, walks, S]`` the O'Neil kernels take."""
    t = _as_tensor(bits).to(torch.int32)
    return t.reshape(q_n, walks, s_count).contiguous().to(device)


# ---------------------------------------------------------------------------
# the five programs
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def distributed_wide_or_cardinality(mesh):
    """The step ``words [N/nc, W/nw] -> (reduced [W/nw], cardinality)``
    over the mesh: a local OR of the rows (``rb_group_reduce``), an
    all-gather over ``containers`` and a local OR of the partials, then a
    popcount (``rb_popcount_rows``) summed over ``words``. The cardinality
    is a 0-d int32 tensor, the same on every rank."""
    n_c = axis_size(mesh, "containers")

    def step(words: torch.Tensor):
        local = kernels.group_reduce(words, _dense_plan(1, words.shape[0]), "or")
        partials = _all_gather(mesh, "containers", local[0])
        total = kernels.group_reduce(partials, _dense_plan(1, n_c), "or")
        card = kernels.popcount_rows(total)
        _all_reduce_sum(mesh, "words", card)
        return total[0], card[0]

    return step


@functools.lru_cache(maxsize=8)
def distributed_grouped_reduce(mesh, op: str = "or"):
    """The grouped step ``[G, M/nc, W/nw] -> ([G, W/nw], [G])`` for or,
    and or xor: groups replicated, the row axis sharded along
    ``containers``. The caller pads M with the op identity
    (``store.pad_groups_dense`` with fill ``ops/device._INIT[op]``), the
    identity the folds below start from, so pad rows fold harmlessly on
    every rank. Each group folds locally (``rb_group_reduce``), the [G,
    W/nw] partials are all-gathered over ``containers`` and folded again,
    and each group's popcount is summed over ``words``."""
    if op not in ("or", "and", "xor"):
        raise ValueError(f"op must be 'or', 'and' or 'xor', got {op!r}")
    n_c = axis_size(mesh, "containers")

    def step(words3: torch.Tensor):
        g, m = words3.shape[0], words3.shape[1]
        red = kernels.group_reduce(words3, _dense_plan(g, m), op)
        partials = _all_gather(mesh, "containers", red)  # [nc, G, W/nw]
        total = kernels.group_reduce(
            partials.transpose(0, 1).contiguous(), _dense_plan(g, n_c), op
        )
        cards = kernels.popcount_rows(total)
        _all_reduce_sum(mesh, "words", cards)
        return total, cards

    return step


@functools.lru_cache(maxsize=8)
def distributed_bsi_compare(mesh, op_name: str):
    """The sharded O'Neil compare: ``(slices [S, K/nc, W/nw], bits, ebm
    [K/nc, W/nw], fixed [K/nc, W/nw]) -> (result words [K/nc, W/nw], cards
    [K/nc])``. ``bits`` holds the predicate bits high slice first, ``[S]``
    (``[2, S]`` for RANGE: the low bound's walk, then the high bound's).
    The slice walk is elementwise over key chunks and words, so it runs
    with no traffic (``rb_oneil_compare``); the only collective is the
    ``words`` SUM of the per-chunk counts."""
    walks = 2 if op_name == "RANGE" else 1

    def step(slices_w, bits, ebm_w, fixed_w):
        qbits = _walk_bits(bits, 1, walks, slices_w.shape[0], slices_w.device)
        out, cards = kernels.oneil_compare(slices_w, qbits, ebm_w, fixed_w, op_name)
        cards = cards[0].contiguous()
        _all_reduce_sum(mesh, "words", cards)
        return out, cards

    return step


@functools.lru_cache(maxsize=8)
def distributed_bsi_sum(mesh):
    """The sharded BSI sum (RoaringBitmapSliceIndex.sum, :581-592):
    ``(slices [S, K/nc, W/nw], found [K/nc, W/nw]) -> counts [S, K/nc]``,
    each the popcount of ``slice & found`` (the masked
    ``rb_popcount_rows``) summed over ``words``. The 2^i weighting runs on
    the host in exact Python ints."""

    def step(slices_w, found_w):
        s_count, k = slices_w.shape[0], slices_w.shape[1]
        if s_count and k:
            counts = kernels.popcount_rows(slices_w, mask=found_w).view(s_count, k)
        else:
            counts = torch.zeros((s_count, k), dtype=torch.int32, device=slices_w.device)
        return _all_reduce_sum(mesh, "words", counts)

    return step


@functools.lru_cache(maxsize=8)
def distributed_bsi_counts_many(mesh, op_name: str):
    """The sharded batched counts: ``(slices [S, K/nc, W/nw], bits [Q, S]
    ([Q, 2, S] for RANGE), ebm, fixed) -> counts [Q, K/nc]``. Q count-only
    O'Neil walks over the shared shard (``rb_oneil_counts``, one launch for
    the batch), then one ``words`` SUM of the ``[Q, K/nc]`` counts."""
    walks = 2 if op_name == "RANGE" else 1

    def step(slices_w, bits, ebm_w, fixed_w):
        qbits = _walk_bits(bits, len(bits), walks, slices_w.shape[0], slices_w.device)
        _, cards = kernels.oneil_compare(slices_w, qbits, ebm_w, fixed_w, op_name, count_only=True)
        return _all_reduce_sum(mesh, "words", cards.contiguous())

    return step
