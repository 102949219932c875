#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py                 # all phases
    python3 chip_smoke.py --only kernels  # phases 1-3: card, build, kernels

Phases, each printed as it runs; any failure exits non-zero with no result:

1. card: ``nvidia-smi`` name and power limit, torch's device name and count;
2. build: ``nvcc`` of ``roaringbitmap_tpu_torch/csrc/*.cu`` with
   ``-Xptxas -v`` (registers, shared memory, spills);
3. kernels against their plain PyTorch versions at the main path's shapes —
   ``rb_group_reduce`` dense ``[31, 10000, 2048]``, CSR over skewed
   offsets and through a row map, for or, and and xor; ``rb_popcount_rows``
   at ``[31, 2048]`` and ``[308100, 2048]`` — bitwise equality required,
   with kernel time (CUDA events), bound and the plain version's time;
4. the main path through the port's entry points: 10,000 census-shaped
   bitmaps (built as ``bench.py`` builds them) through
   ``FastAggregation.or_``, ``ParallelAggregation.or_`` and
   ``FastAggregation.or_cardinality`` on the padded layout, XOR over all
   but one of them (copies cancel in pairs, so every row changes the
   answer), then AND/XOR on a smaller set, a bucketed set and a segmented
   set, each against a numpy oracle; the kernel launch counts are zeroed
   before and read after;
5. timing of the main path: pack, expansion, the cold reduce on the real
   rows against the plain fold, steady-state reduce, aggregations per
   second, peak device memory.

The last two lines are a JSON object describing every kernel and the JSON
result ``{"ok": true, "device": {...}}``. The port needs no JAX and nothing
of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0xFEEF1F0
N_BITMAPS = 10_000  # bench.py's working set
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (NVIDIA data sheet)
ROW_BYTES = 2048 * 4
G_MAIN, M_MAIN, ROWS_MAIN = 31, 10_000, 308_100  # the main path's shapes
REPS = 20
E2E_RUNS = 10  # end-to-end runs per median: the pass is host-bound and noisy


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


# ---------------------------------------------------------------------------
# phases 1-2
# ---------------------------------------------------------------------------


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)  # name and power limit, exactly as nvidia-smi gives them
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    say(f"[card] torch {torch.__version__} cuda {torch.version.cuda}: {kind} x{count}")
    return card, kind, count


def phase_build():
    from roaringbitmap_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path, log = _build.build(verbose=True)
    say(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if any(k in line for k in ("registers", "spill", "Compiling entry", "error", "warning")):
            say(f"[build] {line.strip()}")
    _build.load()


# ---------------------------------------------------------------------------
# phase 3: kernels against plain versions
# ---------------------------------------------------------------------------


def _rand_words(gen, n_words: int, op: str) -> torch.Tensor:
    """Words whose or/and/xor over ~10,000 rows keeps about half the bits
    set: sparse single bits for or, their complement for and, dense random
    words for xor."""
    if op == "xor":
        a = torch.empty(n_words, dtype=torch.int32, device="cuda").random_(generator=gen)
        b = torch.empty(n_words, dtype=torch.int32, device="cuda").random_(generator=gen)
        return a ^ (b << 1)
    w = torch.zeros(n_words, dtype=torch.int32, device="cuda")
    nnz = int(n_words * 0.0022)
    idx = torch.randint(0, n_words, (nnz,), device="cuda", generator=gen)
    pos = torch.randint(0, 32, (nnz,), device="cuda", generator=gen, dtype=torch.int64)
    w[idx] = (torch.ones_like(pos) << pos).to(torch.int32)
    return ~w if op == "and" else w


def _compare(name, got, want):
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        fail(f"{name}: kernel disagrees with plain version in {bad} words")
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


def phase_kernels(card: str):
    from roaringbitmap_tpu_torch.ops import kernels as K

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    results = {}
    W = 2048

    # skewed CSR offsets: 31 segments, sizes growing ~1.3x each, 308,100 rows
    ladder = 1.3 ** np.arange(G_MAIN)
    sizes = np.maximum(1, np.floor(ladder / ladder.sum() * ROWS_MAIN)).astype(np.int64)
    sizes[-1] += ROWS_MAIN - sizes.sum()
    csr_offsets = np.concatenate(([0], np.cumsum(sizes)))
    # row map: 308,100 flat rows scattered over the 31 x 10,000 slots; the
    # other slots are identity pads (value = row count)
    slots = np.sort(rng.choice(G_MAIN * M_MAIN, size=ROWS_MAIN, replace=False))
    src_map = np.full(G_MAIN * M_MAIN, ROWS_MAIN, dtype=np.int64)
    src_map[slots] = rng.permutation(ROWS_MAIN)
    row_map = torch.from_numpy(src_map).cuda()

    dense_plan = K.SegmentPlan.dense(G_MAIN, M_MAIN)
    csr_plan = K.SegmentPlan.csr(csr_offsets)
    live_dense = G_MAIN * M_MAIN
    cases = [
        ("dense", dense_plan, None, live_dense, "roaringbitmap_tpu/ops/pallas_kernels.py:397"),
        ("csr", csr_plan, None, ROWS_MAIN, "roaringbitmap_tpu/ops/pallas_kernels.py:543"),
        ("rowmap", dense_plan, row_map, ROWS_MAIN, "roaringbitmap_tpu/ops/pallas_kernels.py:941"),
    ]
    for op in ("or", "and", "xor"):
        words = _rand_words(gen, G_MAIN * M_MAIN * W, op).view(G_MAIN * M_MAIN, W)
        for mode, plan, rmap, live, replaces in cases:
            src = words if mode == "dense" else words[:ROWS_MAIN]
            got = K.group_reduce(src, plan, op, row_map=rmap)
            want = K.group_reduce_plain(src, plan, op, row_map=rmap)
            err = _compare(f"rb_group_reduce[{mode}] {op}", got, want)
            ms = cuda_ms(lambda: K.group_reduce(src, plan, op, row_map=rmap))
            plain = cuda_ms(lambda: K.group_reduce_plain(src, plan, op, row_map=rmap), reps=3, warmup=1)
            nbytes = live * ROW_BYTES + plan.n_groups * ROW_BYTES
            if rmap is not None:
                nbytes += rmap.numel() * 8
            b = bound_ms(nbytes)
            set_bits = int(K.popcount_rows(got).sum())
            say(
                f"[kernel] rb_group_reduce[{mode}] {op} G={plan.n_groups} rows={live} "
                f"chunks={len(plan.chunks)}: equal (result bits {set_bits}); "
                f"{ms:.4f} ms, bound {b:.4f} ms ({b / ms:.1%} of bound), "
                f"plain {plain:.3f} ms; library call: none  [{card}]"
            )
            if op == "or":
                results[f"rb_group_reduce[{mode}]"] = dict(
                    replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain,
                    bound_ms=b,
                )
        del words
    torch.cuda.empty_cache()

    dense = _rand_words(gen, ROWS_MAIN * W, "xor").view(ROWS_MAIN, W)
    for rows in (G_MAIN, ROWS_MAIN):
        src = dense[:rows]
        got = K.popcount_rows(src)
        want = K.popcount_rows_plain(src)
        err = _compare(f"rb_popcount_rows [{rows}, 2048]", got, want)
        ms = cuda_ms(lambda: K.popcount_rows(src))
        plain = cuda_ms(lambda: K.popcount_rows_plain(src), reps=3, warmup=1)
        b = bound_ms(rows * ROW_BYTES + rows * 4)
        say(
            f"[kernel] rb_popcount_rows [{rows}, 2048]: equal; {ms:.4f} ms, "
            f"bound {b:.4f} ms ({b / ms:.1%} of bound), plain {plain:.3f} ms; "
            f"library call: none  [{card}]"
        )
        if rows == ROWS_MAIN:
            results["rb_popcount_rows"] = dict(
                replaces="roaringbitmap_tpu/ops/device.py:103", max_abs_err=err,
                ms=ms, plain_ms=plain, bound_ms=b,
            )
    del dense
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def build_working_set():
    """bench.py's working set: the census1881 corpus, or its seeded
    synthetic stand-in, cycled to 10,000 bitmaps."""
    from roaringbitmap_tpu_torch import RoaringBitmap
    from roaringbitmap_tpu_torch.utils import datasets

    base, real = datasets.load_or_synthesize("census1881")
    bitmaps = []
    i = 0
    while len(bitmaps) < N_BITMAPS:
        bitmaps.append(RoaringBitmap(base[i % len(base)]))
        i += 1
    return base, bitmaps, real


def _count_oracle(values, n):
    u, c = np.unique(np.concatenate(values), return_counts=True)
    return u[c == n].astype(np.uint32), u[c % 2 == 1].astype(np.uint32)


def _check(name, bm, oracle):
    got = bm.to_array()
    if got.shape != oracle.shape or not np.array_equal(got, oracle):
        fail(f"{name}: result ({got.size} values) differs from the numpy oracle ({oracle.size})")
    say(f"[main] {name}: {got.size} values, equal to the numpy oracle")


def _layout_delta(store, before):
    return {k: v - before[k] for k, v in store.LAYOUT_COUNTS.items() if v != before[k]}


def phase_main(rng):
    from roaringbitmap_tpu_torch import FastAggregation, ParallelAggregation, RoaringBitmap
    from roaringbitmap_tpu_torch.ops import kernels as K
    from roaringbitmap_tpu_torch.parallel import store

    t0 = time.perf_counter()
    base, bitmaps, real = build_working_set()
    n_cont = sum(b.get_container_count() for b in bitmaps)
    say(
        f"[main] {len(bitmaps)} bitmaps ({'census1881' if real else 'synthetic census1881-like'}), "
        f"{n_cont} containers, built in {time.perf_counter() - t0:.1f} s"
    )
    oracle_or = np.unique(np.concatenate(base[: min(len(base), N_BITMAPS)]))

    # smaller sets for AND/XOR (half run-optimized) and the skewed layouts
    and_vals = []
    for _ in range(64):
        dense = np.flatnonzero(rng.random(8 << 16) < 0.97)
        extra = rng.integers(8 << 16, 24 << 16, size=3000)
        and_vals.append(np.union1d(dense, extra).astype(np.uint32))
    and_bms = [RoaringBitmap(v) for v in and_vals]
    for b in and_bms[::2]:
        b.run_optimize()
    oracle_and, oracle_xor = _count_oracle(and_vals, len(and_vals))

    def key_values(key, count):
        return ((key << 16) + rng.choice(1 << 16, size=count, replace=False)).astype(np.uint32)

    bucket_vals = [
        np.concatenate([key_values(k, int(rng.integers(100, 3000))) for k in range(8)])
        for _ in range(64)
    ] + [key_values(8 + k, 500) for k in range(8)]
    sizes = np.round(146 ** (np.arange(18) / 17)).astype(int)
    seg_vals = []
    for j in range(int(sizes.max())):
        parts = [key_values(k, int(rng.integers(1, 5000))) for k in range(18) if j < sizes[k]]
        seg_vals.append(np.concatenate(parts))
    bucket_bms = [RoaringBitmap(v) for v in bucket_vals]
    seg_bms = [RoaringBitmap(v) for v in seg_vals]

    K.reset_launches()
    for k in store.LAYOUT_COUNTS:
        store.LAYOUT_COUNTS[k] = 0
    # --- the main path: every aggregation below runs with the counts live ---
    before = dict(store.LAYOUT_COUNTS)
    r = FastAggregation.or_(*bitmaps)
    _check(f"FastAggregation.or_ ({len(bitmaps)} bitmaps)", r, oracle_or)
    if _layout_delta(store, before) != {"padded": 1}:
        fail(f"main-path layout was {_layout_delta(store, before)}, expected padded")
    r = ParallelAggregation.or_(*bitmaps)
    _check(f"ParallelAggregation.or_ ({len(bitmaps)} bitmaps)", r, oracle_or)
    card = FastAggregation.or_cardinality(*bitmaps)
    if card != oracle_or.size:
        fail(f"FastAggregation.or_cardinality = {card}, oracle {oracle_or.size}")
    say(f"[main] FastAggregation.or_cardinality ({len(bitmaps)} bitmaps): {card}, equal to the oracle")
    # The set repeats its base bitmaps, so OR would not notice a lost row.
    # XOR over all but the last bitmap does: copies cancel in pairs, the
    # base bitmaps of odd multiplicity remain, and every row changes the
    # answer.
    sub = bitmaps[:-1]
    mult = np.bincount(np.arange(len(sub)) % len(base), minlength=len(base))
    odd = [base[i] for i in np.flatnonzero(mult % 2)]
    _check(f"FastAggregation.xor ({len(sub)} bitmaps, {len(odd)} of odd multiplicity)",
           FastAggregation.xor(*sub), _count_oracle(odd, len(odd))[1])
    if store.LAYOUT_COUNTS != {"padded": 4, "bucketed": 0, "segmented-scan": 0}:
        fail(f"wide-set layouts were {store.LAYOUT_COUNTS}, expected padded x4")
    wide = dict(K.LAUNCHES)
    say(f"[main] launches over the wide-set OR and XOR runs: {wide}")
    if wide["rb_group_reduce[rowmap]"] < 4 or wide["rb_popcount_rows"] < 4:
        fail("the wide-set runs did not go through rb_group_reduce and rb_popcount_rows")

    _check("FastAggregation.and_ (64 bitmaps, half run-optimized)",
           FastAggregation.and_(*and_bms, mode="device"), oracle_and)
    _check("FastAggregation.xor (64 bitmaps, half run-optimized)",
           FastAggregation.xor(*and_bms, mode="device"), oracle_xor)
    for name, bms, vals, layout in (
        ("bucketed set (8 groups x 64 rows + 8 x 1)", bucket_bms, bucket_vals, "bucketed"),
        ("segmented set (18 groups, 1..146 rows)", seg_bms, seg_vals, "segmented-scan"),
    ):
        before = dict(store.LAYOUT_COUNTS)
        _check(f"FastAggregation.or_ {name}", FastAggregation.or_(*bms, mode="device"),
               np.unique(np.concatenate(vals)))
        if _layout_delta(store, before) != {layout: 1}:
            fail(f"{name}: layout {_layout_delta(store, before)}, expected {layout}")
    launches = dict(K.LAUNCHES)
    say(f"[main] launches over the main path: {launches}; layouts {store.LAYOUT_COUNTS}")
    for k, v in launches.items():
        if v == 0:
            fail(f"kernel {k} was not launched on the main path")
    return bitmaps, launches


# ---------------------------------------------------------------------------
# phase 5: timing
# ---------------------------------------------------------------------------


def phase_timing(bitmaps, card: str):
    from roaringbitmap_tpu_torch import FastAggregation
    from roaringbitmap_tpu_torch.ops import kernels as K
    from roaringbitmap_tpu_torch.parallel import store

    torch.cuda.synchronize()
    t_start = time.perf_counter()
    groups = store.group_by_key(bitmaps)
    t_groups = time.perf_counter()
    packed = store.pack_groups(groups, "cuda")
    t_payload = time.perf_counter()
    packed._payload.materialize()
    t_concat = time.perf_counter()
    t_pack = t_concat - t_start
    t0 = time.perf_counter()
    flat = packed.device_words
    torch.cuda.synchronize()
    t_expand = time.perf_counter() - t0
    say(
        f"[time] pack {t_pack * 1e3:.1f} ms (group_by_key {(t_groups - t_start) * 1e3:.1f}, "
        f"payload {(t_payload - t_groups) * 1e3:.1f}, concatenate {(t_concat - t_payload) * 1e3:.1f}); "
        f"expansion (ship payload + expand on device) {t_expand * 1e3:.1f} ms "
        f"for {packed.n_rows} rows, {packed._payload.nbytes} payload bytes  [{card}]"
    )
    run, layout = store.prepare_reduce(packed, "or")
    t0 = time.perf_counter()
    red, cards = run()
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    # the cold row-map run on the real rows, against the plain CSR fold of
    # the same flat rows
    want = K.group_reduce_plain(flat, K.SegmentPlan.csr(packed.group_offsets), "or")
    _compare("cold prepare_reduce run() on the real rows", red, want)
    if not torch.equal(cards, K.popcount_rows_plain(want)):
        fail("cold prepare_reduce run(): cardinalities differ from the plain popcount")
    say(f"[time] cold run() on the {packed.n_rows} real rows: equal to the plain CSR fold and popcount")
    del want
    run, layout = store.prepare_reduce(packed, "or")  # second touch: padded block
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    t_second = time.perf_counter() - t0
    steady = cuda_ms(run)
    live = packed.n_rows * ROW_BYTES
    say(
        f"[time] prepare_reduce layout={layout}: cold run (row map) {t_cold * 1e3:.3f} ms, "
        f"second touch (builds padded block) {t_second * 1e3:.3f} ms, steady run() "
        f"{steady:.4f} ms over {REPS} reps (reduce + popcount; bound {bound_ms(live):.4f} ms "
        f"for {packed.n_rows} live rows)  [{card}]"
    )
    t0 = time.perf_counter()
    words, cards = store.reduce_packed(packed, "or")
    r = store.unpack_to_bitmap(packed.group_keys, words, cards)
    t_unpack = time.perf_counter() - t0
    say(f"[time] reduce_packed + unpack_to_bitmap {t_unpack * 1e3:.1f} ms ({r.get_cardinality()} values)  [{card}]")
    del flat, red, packed
    torch.cuda.empty_cache()

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        FastAggregation.or_(*bitmaps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies): a CPU op's own entry
    # repeats the device time of the kernels it launched
    by_name = sorted(
        ((e.self_device_time_total, e.key) for e in prof.key_averages()
         if e.device_type != DeviceType.CPU and e.self_device_time_total > 0),
        reverse=True,
    )
    dev_us = sum(t for t, _ in by_name)
    if dev_us:
        top = "; ".join(f"{k[:60]} {t / 1e3:.3f} ms" for t, k in by_name[:6])
        say(
            f"[time] profiled FastAggregation.or_: wall {wall * 1e3:.1f} ms, device busy "
            f"{dev_us / 1e3:.3f} ms ({dev_us / 1e6 / wall:.2%}), idle share "
            f"{1 - dev_us / 1e6 / wall:.2%}; top: {top}  [{card}]"
        )
    else:
        say("[time] profiled FastAggregation.or_: device time not measured (the profiler showed none)")

    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(E2E_RUNS):
        t0 = time.perf_counter()
        FastAggregation.or_(*bitmaps)  # returns a host bitmap: the work is done
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    med = float(np.median(walls))
    say(
        f"[time] FastAggregation.or_ end to end ({len(bitmaps)} bitmaps, pack to bitmap), "
        f"{len(walls)} runs: median {med * 1e3:.1f} ms (min {min(walls) * 1e3:.1f}, "
        f"max {max(walls) * 1e3:.1f}), {1 / med:.3f} aggregations/s; peak device memory "
        f"{peak / 2**30:.2f} GiB ({peak} bytes)  [{card}]"
    )


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=["kernels"], help="run phases 1-3 only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    t_start = time.perf_counter()
    card, kind, count = phase_card()
    phase_build()
    timings = phase_kernels(card)
    launches = None  # not counted unless phase 4 runs
    if args.only is None:
        bitmaps, launches = phase_main(np.random.default_rng(SEED))
        phase_timing(bitmaps, card)
    kernels = []
    for name, t in timings.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "roaringbitmap_tpu_torch/csrc/reduce.cu",
            "replaces": t["replaces"],
            "launches": None if launches is None else launches[name],
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
        })
    say(f"[done] {time.perf_counter() - t_start:.1f} s  [{card}]")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
