"""TPC-H Q6 over ``lineitem``: the plain reference against a hand-written
Q6 on a small table with planted boundary rows, the generator against
Clause 4.2.3, the request draws against Clause 2.4.6.3, the least work
from shapes, the BSI layer's readers, and the kind's refusal of a port
without resident found sets."""

from __future__ import annotations

import importlib
import subprocess
import sys
from decimal import Decimal
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import bounds, loop
from portbench.configs import tpch_lineitem as li
from portbench.metrics import bsi_call_ms, bsi_resident_share
from portbench.reading import Reading

PKG = Path(li.__file__).resolve().parents[1]
DAY0 = np.datetime64("1992-01-01")


def _hand_q6(table: dict, year: int, disc: int, qty: int):
    """Q6 as Clause 2.4.6 writes it, on dates and decimals: (revenue in
    cents x hundredths, count)."""
    ship = DAY0 + table["shipdate"].astype("timedelta64[D]")
    lo, hi = np.datetime64(f"{year}-01-01"), np.datetime64(f"{year + 1}-01-01")
    d = Decimal(disc) / 100
    revenue, count = Decimal(0), 0
    for s, p, x, q in zip(ship, table["price"].tolist(), table["discount"].tolist(),
                          table["quantity"].tolist()):
        x = Decimal(x) / 100
        if lo <= s < hi and d - Decimal("0.01") <= x <= d + Decimal("0.01") and q < qty:
            revenue += Decimal(p) / 100 * x
            count += 1
    return int(revenue * 10_000), count


def _table(rows: int, seed: int, year: int, disc: int, qty: int) -> dict:
    """``rows`` drawn rows and the planted boundary rows of one request."""
    t = {k: v.numpy().astype(np.int64) for k, v in
         li.columns({"rows": rows, "parts": 2_000_000}, seed, torch.device("cpu")).items()}
    first, last = li.year_days(year)
    planted = [  # shipdate, discount, quantity, price; the comment: in or out
        (first, disc, qty - 1, 1_000_001),  # the first day: in
        (last, disc + 1, qty - 1, 1_000_003),  # the last day, DISCOUNT + 0.01: in
        (last + 1, disc, qty - 1, 1_000_007),  # DATE + 1 year: out
        (first - 1, disc, qty - 1, 1_000_009),  # the day before: out
        (first + 9, disc - 1, qty - 1, 1_000_013),  # DISCOUNT - 0.01: in
        (first + 9, disc - 2, qty - 1, 1_000_019),  # DISCOUNT - 0.02: out
        (first + 9, disc + 2, qty - 1, 1_000_021),  # DISCOUNT + 0.02: out
        (first + 9, disc, qty, 1_000_031),  # QUANTITY itself: out
    ]
    for name, col in zip(("shipdate", "discount", "quantity", "price"), zip(*planted)):
        t[name] = np.concatenate([t[name], np.array(col, dtype=np.int64)])
    return t


@pytest.mark.parametrize("year, disc, qty", [(1994, 6, 24), (1997, 2, 25), (1993, 9, 24)])
def test_the_reference_is_the_hand_written_q6_with_its_boundaries(year, disc, qty):
    table = _table(3_000, year * 100 + disc, year, disc, qty)
    dep = li.Deployment({"rows": table["price"].size, "parts": 1}, 0, torch.device("cpu"))
    dep._table = {k: torch.from_numpy(v.astype(np.int32)) for k, v in table.items()}
    revenue, count = _hand_q6(table, year, disc, qty)
    assert count > 3  # the three planted rows that are in, and drawn ones
    assert dep.q6((year, disc, qty)).tolist() == [revenue, count]
    # each planted row moves the answer as its comment says
    n = table["price"].size
    for i, inside in zip(range(n - 8, n), (True, True, False, False, True, False, False, False)):
        less = {k: np.delete(v, i) for k, v in table.items()}
        r, c = _hand_q6(less, year, disc, qty)
        assert (c == count - 1) is inside and (c == count) is not inside
    # the float32 engine's revenue is not exact
    assert dep.q6((year, disc, qty), float32=True)[0] != revenue


def test_the_generator_keeps_to_clause_4_2_3():
    cfg = {"rows": 200_000, "parts": 20_000_000}
    cols = li.columns(cfg, 2**40 + 3, torch.device("cpu"))
    assert {k: v.numel() for k, v in cols.items()} == dict.fromkeys(li.COLUMNS, 200_000)
    ship, disc, qty, price = (cols[k].numpy().astype(np.int64) for k in li.COLUMNS)
    assert 1 <= ship.min() and ship.max() <= 2_526 == li.TOP["shipdate"]
    assert set(np.unique(disc)) == set(range(11))
    assert set(np.unique(qty)) == set(range(1, 51))
    retail = price // qty
    assert np.all(price == qty * retail) and 90_000 <= retail.min() and retail.max() <= 209_900
    assert price.max() <= li.TOP["price"] == 10_495_000
    assert li.SLICES == {"shipdate": 12, "discount": 4, "quantity": 6, "price": 24}
    # P_RETAILPRICE in cents, as Clause 4.2.3 computes it in dollars
    pk = torch.tensor([1, 10, 999, 1_000, 200_009])
    assert li.retail_price(pk).tolist() == [90_100, 91_001, 189_999, 90_100, 110_900]
    # the same seed draws the same table, another seed another
    again = li.columns(cfg, 2**40 + 3, torch.device("cpu"))
    assert all(torch.equal(cols[k], again[k]) for k in li.COLUMNS)
    other = li.columns(cfg, 2**40 + 4, torch.device("cpu"))
    assert not torch.equal(cols["price"], other["price"])
    assert li.year_days(1992) == (0, 365) and li.year_days(1994) == (731, 1_095)
    # SF 100: 9,156 chunks of 65,536 rows
    assert li.Deployment({"rows": 600_037_902, "parts": 1}, 0, None).chunks == 9_156


def test_requests_follow_clause_2_4_6_3():
    from portbench.kinds import tpch_q6

    params = {"years": [1993, 1997], "discounts": [2, 9], "quantities": [24, 25]}
    rng = loop.client_rng(2**33 + 5, loop.WINDOW, 0)
    seen = [tpch_q6.draw(rng, None, params) for _ in range(2_000)]
    years, discs, qtys = (set(x) for x in zip(*seen))
    assert years == set(range(1993, 1998))
    assert discs == set(range(2, 10)) and qtys == {24, 25}


def test_the_least_work_counts_every_slice_and_the_existence_rows_once():
    from portbench.kinds import tpch_q6

    sf100 = SimpleNamespace(slices=dict(li.SLICES), chunks=9_156)
    nbytes = 47 * 9_156 * bounds.ROW_BYTES + 25 * 9_156 * 4
    assert tpch_q6.least_seconds(sf100, {}, (1994, 6, 24)) == bounds.bytes_seconds(nbytes)
    assert tpch_q6.least_seconds(sf100, {}, (1994, 6, 24)) * 1e3 == pytest.approx(1.0526, abs=1e-4)


def test_the_reference_imports_neither_the_port_nor_jax():
    code = (
        "import sys, torch\n"
        "from portbench.configs import tpch_lineitem as li\n"
        "dep = li.Deployment({'rows': 50_000, 'parts': 20_000_000}, 7, torch.device('cpu'))\n"
        "print('ANSWER', dep.q6((1995, 5, 24)).tolist(), dep.q6((1995, 5, 24), float32=True).tolist())\n"
        "print('LOADED', sorted({m.split('.')[0] for m in sys.modules}"
        " & {'jax', 'jaxlib', 'roaringbitmap_tpu', 'roaringbitmap_tpu_torch'}))\n"
    )
    p = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "LOADED []" in p.stdout and "ANSWER" in p.stdout


def _reading(before, after):
    return Reading(seconds=1.0, completed=10, setup_s=1.0, latencies_ms=np.ones(10), least_s=None,
                   device=None, timings_before=before, timings_after=after,
                   pack_before={}, pack_after={})


def _timer(count, total_s):
    return {"count": count, "total_s": total_s}


def test_the_bsi_readers_read_the_window_and_nothing_where_the_port_has_no_spans():
    before = {"bsi.compare": _timer(4, 0.5), "bsi.found.resident": _timer(2, 0.01)}
    after = {"bsi.compare": _timer(64, 0.5 + 0.30), "bsi.sum": _timer(30, 0.20),
             "bsi.found.resident": _timer(82, 0.05), "bsi.found.marshal": _timer(20, 0.1)}
    r = _reading(before, after)
    assert bsi_call_ms.read(r) == pytest.approx((0.30 + 0.20) / 10 * 1e3)
    assert bsi_resident_share.read(r) == pytest.approx(80 / 100 * 100)
    assert bsi_resident_share.read(_reading({}, {"bsi.found.resident": _timer(5, 0.1)})) == 100.0
    parent = _reading({}, {"store.unpack_to_bitmap": _timer(3, 0.1)})
    assert bsi_call_ms.read(parent) is None and bsi_resident_share.read(parent) is None


def test_the_kind_refuses_a_port_without_resident_found_sets(monkeypatch):
    """The parent of the resident path lacks ``ResidentSet``: the harness's
    import of the kind fails before any data is drawn."""
    from roaringbitmap_tpu_torch.models import bsi

    monkeypatch.delattr(bsi, "ResidentSet")
    monkeypatch.delitem(sys.modules, "portbench.kinds.tpch_q6", raising=False)
    with pytest.raises(ImportError, match="ResidentSet"):
        importlib.import_module("portbench.kinds.tpch_q6")
