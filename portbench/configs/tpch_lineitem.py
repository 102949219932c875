"""Maker of TPC-H ``lineitem`` as the four bit-sliced columns Query 6 reads,
and its plain reference.

The rows follow Clause 4.2.3 of the TPC-H Standard Specification, drawn on
the device from the seed with ``torch.Generator``: orders in key order, each
with 1 to 7 lines (the last order cut at the row count), O_ORDERDATE
uniform over [1992-01-01, 1998-08-02], L_SHIPDATE = O_ORDERDATE + [1, 121]
days, L_DISCOUNT uniform over 0.00-0.10, L_QUANTITY over 1-50, L_PARTKEY
over 1 .. ``parts`` and L_EXTENDEDPRICE = L_QUANTITY x P_RETAILPRICE
(L_PARTKEY). Each column is held as a non-negative integer: the ship date in
days since 1992-01-01, the discount in hundredths, the price in cents. The
row id is the row's position; every row is present. The columns Q6 does not
read are not drawn.

The benchmark writes each column's index in the upstream BSI wire format
(``bsi_column.slice_rows``, ``wire.bsi_bytes``: the bit transpose runs on
the device) and the port opens the bytes with
``RoaringBitmapSliceIndex.deserialize``, as a serving process opens a stored
segment; the drawn columns and the bytes are freed as each column opens.

The reference regenerates the columns from the seed and evaluates Q6 with
boolean masks and an int64 sum, in plain PyTorch.
"""

from __future__ import annotations

import math
from datetime import date

import numpy as np
import torch

from .. import wire
from .bsi_column import slice_rows

EPOCH = date(1992, 1, 1)
ORDER_DAYS = (date(1998, 8, 2) - EPOCH).days + 1  # O_ORDERDATE: [STARTDATE, ENDDATE - 151]
SHIP_LAG = (1, 121)  # L_SHIPDATE - O_ORDERDATE, days
LINES = (1, 7)  # lines an order
DISCOUNT = (0, 10)  # hundredths
QUANTITY = (1, 50)
COLUMNS = ("shipdate", "discount", "quantity", "price")


def retail_price(partkey: torch.Tensor) -> torch.Tensor:
    """P_RETAILPRICE in cents (Clause 4.2.3)."""
    return 90_000 + (partkey // 10) % 20_001 + 100 * (partkey % 1_000)


# the largest value each column can hold, and so its slices
TOP = {
    "shipdate": ORDER_DAYS - 1 + SHIP_LAG[1],
    "discount": DISCOUNT[1],
    "quantity": QUANTITY[1],
    "price": QUANTITY[1] * (90_000 + 20_000 + 100 * 999),
}
SLICES = {name: top.bit_length() for name, top in TOP.items()}


def year_days(year: int):
    """[DATE, DATE + 1 year) of Q6 as (first, last) day since 1992-01-01."""
    return (date(year, 1, 1) - EPOCH).days, (date(year + 1, 1, 1) - EPOCH).days - 1


def columns(cfg: dict, seed: int, device: torch.device) -> dict:
    """The four columns, int32 ``[rows]`` on ``device``, from ``seed``."""
    rows = int(cfg["rows"])
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))

    def uniform(lo, hi, n):
        return torch.randint(lo, hi + 1, (n,), generator=g, device=device, dtype=torch.int32)

    # enough orders at 4 lines each, by 32 standard deviations
    n_orders = rows // 4 + 8 * math.isqrt(rows) + 64
    lines = uniform(*LINES, n_orders)
    ordered = uniform(0, ORDER_DAYS - 1, n_orders)
    ends = torch.cumsum(lines, 0, dtype=torch.int64)
    taken = int(torch.searchsorted(ends, torch.tensor([rows], device=device))[0]) + 1
    if taken > n_orders:
        raise RuntimeError(f"{n_orders} orders hold fewer than {rows} lines")
    lines = lines[:taken].to(torch.int64)
    lines[-1] -= int(ends[taken - 1]) - rows
    del ends
    shipdate = torch.repeat_interleave(ordered[:taken], lines, output_size=rows)
    del ordered, lines
    shipdate += uniform(*SHIP_LAG, rows)
    discount = uniform(*DISCOUNT, rows)
    quantity = uniform(*QUANTITY, rows)
    price = quantity * retail_price(uniform(1, int(cfg["parts"]), rows))
    return {"shipdate": shipdate, "discount": discount, "quantity": quantity, "price": price}


def draw(cfg: dict, seed: int, device: torch.device) -> dict:
    """Each column's slice rows, bit transposed on the device: ``{"seed",
    "columns": {name: (uint64 [S, K, 1024] rows, [S, K] counts, min,
    max)}}``."""
    cols = columns(cfg, seed, device)
    out = {}
    for name in COLUMNS:
        v = cols.pop(name)
        lo, hi = int(v.min()), int(v.max())
        words, cards = slice_rows(v.to(torch.int64), SLICES[name])
        del v
        out[name] = (words, cards, lo, hi)
    return {"seed": seed, "columns": out}


class Deployment:
    def __init__(self, cfg: dict, seed: int, device: torch.device):
        self.cfg = cfg
        self.seed = seed
        self.device = device
        self.rows = int(cfg["rows"])
        self.chunks = -(-self.rows // wire.CHUNK)
        self.slices = dict(SLICES)
        self.index = {}  # column name -> the port's RoaringBitmapSliceIndex
        self._table = None
        self._answers = {}

    def free_program(self) -> None:
        self.index = None

    # ---- the plain reference ------------------------------------------
    def table(self) -> dict:
        """The columns drawn again from the seed (int32 on the device)."""
        if self._table is None:
            self._table = columns(self.cfg, self.seed, self.device)
        return self._table

    def q6(self, request, float32: bool = False) -> np.ndarray:
        """Q6 over the table: int64 ``[revenue, count]``, revenue in cents x
        hundredths (Σ l_extendedprice x l_discount). With ``float32`` the
        revenue is summed as an engine holding DECIMAL in float32 would:
        dollars times a fraction, summed in float32, scaled back."""
        key = (tuple(request), float32)
        if key not in self._answers:
            year, disc, qty = request
            first, last = year_days(year)
            t = self.table()
            rows = ((t["shipdate"] >= first) & (t["shipdate"] <= last)
                    & (t["discount"] >= disc - 1) & (t["discount"] <= disc + 1)
                    & (t["quantity"] < qty))
            count = int(rows.sum())
            if float32:
                dollars = t["price"].to(torch.float32) / 100
                share = t["discount"].to(torch.float32) / 100
                revenue = round(float((dollars * share * rows).sum()) * 10_000)
            else:
                revenue = int((t["price"] * t["discount"] * rows).sum(dtype=torch.int64))
            self._answers[key] = np.array([revenue, count], dtype=np.int64)
        return self._answers[key]


def load(cfg: dict, drawn: dict, device: torch.device) -> Deployment:
    """Write each column's index bytes and open them with the port's
    ``RoaringBitmapSliceIndex.deserialize``, freeing the slice rows and the
    bytes as each column opens."""
    from roaringbitmap_tpu_torch import RoaringBitmapSliceIndex

    dep = Deployment(cfg, drawn["seed"], device)
    for name in COLUMNS:
        words, cards, lo, hi = drawn["columns"].pop(name)
        data = wire.bsi_bytes(words, cards, dep.rows, lo, hi)
        del words, cards
        dep.index[name] = RoaringBitmapSliceIndex.deserialize(data)
        del data
    return dep
