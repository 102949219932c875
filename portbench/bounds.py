"""The least time a request's logical work needs on one H100, frozen here.

Bytes are counted once each way (every input byte read once, every output
byte written once) at the card's published 3.35 TB/s; logic instructions at
132 SMs x 64 INT32 lanes x the published 1,980 MHz boost clock (NVIDIA H100
SXM data sheet, Hopper architecture white paper). The counts follow the
arithmetic the port's chip script used for its kernel bounds
(``bound_ms``, ``ops_bound_ms``, ``batched_bound``), with the card's
figures fixed instead of read from the device.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
SMS = 132
LOGIC_LANES_PER_SM = 64
SM_HZ = 1.980e9
ROW_WORDS = 2048  # int32 words of one 65,536-bit container row
ROW_BYTES = ROW_WORDS * 4
# logic instructions a column needs, for each 32 slices, to rebuild its
# value (a 32 x 32 bit transpose) and rank it among sorted thresholds,
# whatever the number of thresholds
RANK_OPS_PER_COLUMN = 20


def bytes_seconds(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S


def ops_seconds(logic_ops: float) -> float:
    return logic_ops / (SMS * LOGIC_LANES_PER_SM * SM_HZ)


def least_seconds(nbytes: float, logic_ops: float) -> float:
    """The larger of the byte bound and the instruction bound."""
    return max(bytes_seconds(nbytes), ops_seconds(logic_ops))


def reduce_least_seconds(rows: int, groups: int) -> float:
    """An N-way reduction of ``rows`` container rows into ``groups`` result
    rows with their popcounts: the rows read once, the result rows and one
    int32 count a group written once; one logic instruction a row word."""
    nbytes = rows * ROW_BYTES + groups * (ROW_BYTES + 4)
    return least_seconds(nbytes, rows * ROW_WORDS)


def slice_walk_least_seconds(slices: int, chunks: int, predicates: int,
                             result_rows: bool) -> float:
    """A bit-sliced compare over ``slices`` x ``chunks`` rows: the slices
    and the existence rows read once, ``predicates`` per-chunk int32
    counts written, and, for a compare that returns its set, one result
    row a chunk written. Instructions: ``RANK_OPS_PER_COLUMN`` a column for
    each 32 slices, whatever the number of predicates."""
    nbytes = (slices + 1) * chunks * ROW_BYTES + predicates * chunks * 4
    if result_rows:
        nbytes += chunks * ROW_BYTES
    columns = chunks * ROW_WORDS * 32
    ops = RANK_OPS_PER_COLUMN * -(-slices // 32) * columns
    return least_seconds(nbytes, ops)
