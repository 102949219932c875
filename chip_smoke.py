#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py                 # all phases
    python3 chip_smoke.py --only kernels  # phases 1-3: card, build, kernels
    python3 chip_smoke.py --only paths    # phases 1-2, 5, 8 and 6: the timed paths
    python3 chip_smoke.py --only columnar --window-pairs 9999  # phases 1-2 and 9, all 9,999 pairs
    python3 chip_smoke.py --only serving  # phases 1-2 and 10: the fusion window and the lane
    python3 chip_smoke.py --only host     # phases 1-2, 11 and 6: the native host tier against numpy
    python3 chip_smoke.py --only batch    # phases 1-3 and 12: batch similarity
    python3 chip_smoke.py --only mapped   # phases 1-2, 6, 7 and 13: memory-mapped bitmaps
    python3 chip_smoke.py --only sixtyfour  # phases 1-2 and 14: the 64-bit family
    python3 chip_smoke.py --only mesh     # phases 1-2, 3 (c) and 15: row widths, multi-device
    python3 chip_smoke.py --only observe  # phases 1-2, 16 and 17: instrumentation, faults, health
    python3 chip_smoke.py --only tenants  # phases 1-2 and 18: the cost facade and the serving read path
    python3 chip_smoke.py --only epochs   # phases 1-2 and 19: the serving write path and the durable tier
    python3 chip_smoke.py --only fuzz     # phases 1-2 and 20: the fuzz campaign on the card

``--only paths`` runs only the phases whose end-to-end times PERF.md limits
against a parent commit; copied into a checkout of the parent, it times
the parent's package on the same phases, so both run in one call.

Phases, each printed as it runs; any failure exits non-zero with no result:

1. card: ``nvidia-smi`` name and power limit, torch's device name and count;
2. build: ``nvcc`` of ``roaringbitmap_tpu_torch/csrc/*.cu`` (one compiler
   per source, and one per form of the tensor-core probe ``mma_probe.cu``,
   started together) with ``-Xptxas -v`` (registers, shared memory,
   spills), the all-pairs kernel's registers and dynamic shared memory,
   and the instruction count of the tiled O'Neil walk's
   slice loop from ``cuobjdump -sass``; then ``g++`` of the native host
   tier (``roaringbitmap_tpu_torch/native/kernels.cpp`` for ``ctypes`` and
   ``ext.cpp`` as a CPython extension, started together), with the
   compiler's version, each compile's seconds, ``backend_tier()``, the
   OpenMP thread count and the CPU model;
3. kernels against their plain PyTorch versions at the main paths' shapes —
   ``rb_group_reduce`` dense ``[31, 10000, 2048]``, CSR over skewed
   offsets and through a row map, for or, and and xor; ``rb_popcount_rows``
   at ``[31, 2048]`` and ``[308100, 2048]``; ``rb_oneil_compare`` for all
   seven ops at ``[32, 1526, 2048]`` over values near the predicate (so
   EQ and NEQ answers are far from empty or full; EQ, NEQ and GE also with
   a found set that differs from the ebm), count-only over 64 queries, and
   EQ and RANGE with 70 slices; the tiled count-only walk
   (``rb_oneil_counts``) for every op at Q = 8, 13, 64, 100 and 256, with
   and without a found set, timed against the per-query design at Q = 8,
   64 and 256 beside its byte and operation bounds, the walk's own
   instruction floor and the SM clock; 405-slice batches, which must run
   on the per-query kernel, checked and timed at Q = 64; the
   masked popcount at ``[32, 1526, 2048]``; the one-segment wide reduce at
   ``[131072, 2048]`` for or, and and xor; ``rb_threshold`` on the
   zero-padded ``[31, 10000, 2048]`` block of the census working set's
   real rows at k = 64 and 200, and at an odd shape (G = 1, M = 997, k past
   the counter's width); ``rb_pair_rows`` for and, or, xor and andnot over
   ``[308100, 2048]`` rows and 150,000 random index pairs (repeats and the
   last row included); ``rb_expand_rows`` on the census working set's
   payload (308,100 rows, staged in pinned memory and shipped once) and on
   the expansion's edge cases (adjacent runs, a run ending at 65535, the
   full run, 2,047 runs, a 4,096-value array, bitmap rows) with
   run-optimized census containers; ``rb_pair_rows``' counts-only mode
   (``rb_pair_rows[counts]``, and and andnot, with the rows mode beside
   it) on config 5's ``[64, 16, 2048]`` batch and the census batch
   ``[10000, 31, 2048]``; the tensor-core probe's rates in bit pairs a
   second (wgmma int8 m64n256k32, wgmma b1 m64n256k256, mma.sync b1
   m16n8k256, or "refused by ptxas") and the operand form they choose;
   ``rb_pairwise_and_card`` on (n, m) among 127/128/129 x 255/256/257,
   (1, 1) and (300, 77) at K = 1, 3 and 31, and on all-ones ``[1, 32768,
   2048]`` and ``[1, 65536, 2048]`` rows whose one pair holds 2^31 and
   2^32 bits — bitwise equality required, with kernel time (CUDA events),
   bound and the plain version's time; (c) the four kernels that take a
   row width (``rb_group_reduce`` dense, ``rb_popcount_rows`` plain and
   masked, ``rb_oneil_compare``, ``rb_oneil_counts``) at 1024 and 512
   words on a rank's blocks of the main paths' shapes (``[31, 5000, W]``,
   ``[32, 763, W]``; every op, Q = 64), bitwise against their plain
   versions, the 1024-word rows timed beside their bounds;
4. the main path through the port's entry points: 10,000 census-shaped
   bitmaps (built as ``bench.py`` builds them) through
   ``FastAggregation.or_``, ``ParallelAggregation.or_`` and
   ``FastAggregation.or_cardinality`` on the padded layout, XOR over all
   but one of them (copies cancel in pairs, so every row changes the
   answer), then AND/XOR on a smaller set, a bucketed set and a segmented
   set, each against a numpy oracle; the kernel launch counts are zeroed
   before and read after, and the pack cache must serve the repeats of
   the wide set;
5. timing of the main path: pack (the payload concatenated into pinned
   staging), expansion (copy, ``rb_expand_rows``), the cold reduce on the real
   rows against the plain fold, steady-state reduce, the wide OR end to
   end cold (pack cache closed before each run) and warm (resident pack),
   peak device memory;
8. (run after phase 5) the query path through ``query.execute`` on the
   same 10,000 bitmaps: Q1 ``(or(A) & or(B)) - or(C) | threshold_2(head)``
   (A, B, C the bitmaps whose base index lies in [0, 67), [67, 134) and
   [134, 200); head the first 8) cold, warm with the result cache off and
   warm with one, then after a one-value mutation of a bitmap of A, which
   must take the delta repack; Q2 ``threshold(k, all 10,000)`` for k = 64
   and 200; Q3 ``andnot_nway_cardinality(or(A) & or(B), *C)`` — every
   answer against a numpy oracle over the 200 base bitmaps, the launch
   counts zeroed before each query and read after (one ``rb_threshold``
   per device threshold step), the pack cache's hits, misses and delta
   rows read around each run;
6. the BSI north star through the port's entry points: 100,000,000 rows,
   32 slices, built through ``set_values`` as ``benchmarks/bsi.py`` builds
   it; ``compare`` and ``compare_cardinality`` for every op (with a 5%
   found set, and NEQ with a found set reaching chunks outside the ebm),
   ``compare_cardinality_many`` over 64 quantile thresholds (one launch of
   the tiled walk) and ``sum``, each against a numpy oracle computed from
   the values; launch counts zeroed before and read after; first-query,
   steady-kernel (the batched walk beside its bounds), end-to-end
   and batched timings; peak device memory;
9. (run after phase 8) the columnar pairwise engine on the upstream
   realdata pairwise benchmark (jmh ``RealDataBenchmarkAnd`` / ``Or`` /
   ``Xor`` / ``AndNot``, run-optimized corpora, as ``bench.py:307-314``
   builds it): run-optimized clones of the 10,000 bitmaps, their rows
   resident as ``colrows`` (308,100 rows), and a window of their adjacent
   pairs (the first 2,000 of the 9,999 unless ``--window-pairs`` says
   otherwise) through ``columnar.pairwise_multi(op, pairs, tier="device")``
   for each op (one ``rb_pair_rows`` launch over the window's dense bucket; and /
   andnot have none here, a run-optimized census pair holding no bitmap
   container), every result against numpy's set ops; the routed facade
   (``and_`` / ``or_`` / ``xor`` / ``andnot``, ``and_cardinality``,
   ``intersects``) over the first 199 pairs after ``ensure_calibrated()``,
   and forced onto the device tier, against the per-container walk;
   bitmap-heavy synthetic pairs (64 and 4,096 containers) on the device
   tier against the per-container walk; medians of the window per op with
   its stages, and of the facade's ns per pair on each tier (the tiers
   taking turns); the routed facade fails the phase if it is more than
   35% slower than the per-container walk for any op; the kernels line's
   count for ``rb_pair_rows`` is the window's; the or window's array
   results taken out of their words both ways on the same words (one
   extension call a row, the native tier's way, and
   ``kernels.values_rows``' batches, the numpy tier's), timed and held
   equal;
10. (run after phase 9) serving on the census working set at full width:
   (a) a fusion window of 8 queries through ``query.execute_fused`` — Q1,
   two more ``(or(A) & or(B)) - or(C')`` shapes, ``or(A) & or(B)`` shared
   by five of them, pairwise, andnot and threshold steps that merge
   (two thresholds over the same bases, so one bucket) — every result
   against serial ``execute`` (bytes) and numpy; the merged andnot must be
   one ``rb_pair_rows`` launch and each threshold bucket one
   ``rb_threshold`` launch; window walls fused and serial, cold and warm,
   median of 3 in turns; ``STEP_COUNTS`` and launches; (b)
   ``overlap.run_pipelined`` over four wide ORs of disjoint quarters of
   the 10,000 bitmaps (pack cache closed) against the four run serially
   and numpy, with the lane's overlap ratio, ``rb_expand_rows`` launches
   (the kernels line's count) and the device idle share; (c)
   ``query.execute_pipelined`` over four Q1-shaped queries, one a quarter,
   against serial and numpy;
11. (run after phase 10) the native host tier: every ``rb_*`` entry point
   of ``native/kernels.cpp`` (and the extension's probes), on each binding
   that serves it, against its numpy version on census-shaped inputs (the
   matched containers of adjacent bases, 2,000 pairs; every batch entry
   point over the whole batch, each op), exact, each timed; the delta
   repack's host expansion on each tier; then, with the two host tiers
   taking turns (``native.set_tier``), phase 9's window cut to 500 pairs
   (the numpy tier's andnot takes ~3.1 ms a pair) with its stages, the
   routed facade's and the per-container walk's ns per pair over the 199
   pairs, Q1 cold and warm, and phase 10's fusion window cold and warm,
   every result against numpy; phase 6 then times ``compare`` GE and its
   ``unpack_to_bitmap`` with the tiers in turns;
12. (run after phase 11) batch similarity through ``parallel/batch.py``'s
   entry points, on 10,000 bitmaps built anew from the bases (so phase
   8's mutation stays out): (a) filtered-ANN, BASELINE.md config 5 as
   ``benchmarks/filtered_ann.py`` builds it (a 1M-doc filter at density
   0.3, 64 top-1000 candidate sets): ``batched_cardinality`` and /
   andnot, ``batched_intersects``, ``batched_op`` and / andnot and the 24 x
   24 ``pairwise_and_cardinality`` against the per-query facade, the
   prepared ``run()`` timed in the steady state and the whole call; (b)
   census facet counts, or(A) of phase 8 against all 10,000 bitmaps
   (``[10000, 31, 2048]``): the counts against the plain version for all
   and the facade for 500, ``batched_op`` and's cardinalities for all and
   500 results against ``and_``; (c) the census all-pairs matrix 10,000 x
   10,000 over 31 keys: ``pairwise_and_cardinality`` (auto must pick
   mxu), ``pairwise_jaccard`` and ``pairwise_cardinality`` or / xor /
   andnot, held to the diagonal (the cardinalities), to equal rows and
   columns for equal bitmaps, to the plain version on the 200 x 200 block
   of distinct bases and to the facade on sampled entries; the kernel
   timed (mean of 10) beside its bounds (the operations at the probe's b1
   rate, and at the int8 data sheet's) and the library row ``torch._int_mm``
   over int8 0/1 bits per key (its sum must equal the kernel's matrix);
   the kernel, the plain version and the library row timed whole on the
   first 320 left rows against all 10,000 (the kernels line's shape; the
   plain rows must equal the kernel's and the matrix's); the stages (pack,
   kernel, copy, inclusion-exclusion) and the walls; launch counts zeroed
   before each entry-point call and read after;
7. ``RangeBitmap`` at 10,000,000 rows, for correctness only: appender,
   queries, batched counts, the reference-format bytes and ``map`` of
   them, against numpy; the native-form bytes mapped, whose slices must be
   ``ImmutableRoaringBitmap`` views of the source buffer (no payload
   copied);
13. (run after phase 7) memory-mapped bitmaps through the buffer package:
   the 10,000 census bitmaps serialized into one file (the 200 base
   bitmaps cycled 50 times) in a temporary directory, mapped read-only
   and viewed as 10,000 ``ImmutableRoaringBitmap``s; ``BufferFastAggregation``
   ``or_`` / ``xor`` (all but the last) / ``and_`` (workShy) /
   ``or_cardinality`` and ``BufferParallelAggregation.or_`` with
   ``mode="device"``: cold (pack cache closed before each) on the first
   mapping, cold again on a second mapping, warm on the resident pack
   (every warm call a pack-cache hit under the ``("static", id)``
   fingerprints), and over mixed operands (every other bitmap heap),
   each result against the heap path's bytes and a numpy oracle; the
   launch counts zeroed before and read after; the cold OR's stages on a
   fresh mapping (view build, ``group_by_key``, payload build, pinned
   staging, copy, ``rb_expand_rows``, reduce, unpack), the cold (mapped
   and heap in turns) and warm medians, both profiled (device idle
   share), peak device memory; every per-container native entry point on
   both bindings on mapped words at addresses 2, 4 and 6 (mod 8) against
   numpy; a mapped skewed set on the segmented layout; then phase 6's index
   serialized to a file and mapped as an ``ImmutableBitSliceIndex``: the
   first ``compare(GE, median)`` from the fresh map, the steady ``compare``
   and ``compare_cardinality_many`` over 64 quantiles, each equal to the
   heap index's answer and timed beside phase 6's.

14. (run after phase 13) the 64-bit family: (a) the 10,000 census bitmaps
   lifted to 64 bits (bitmap i's values moved into high-32 bucket
   i // 2500: 308,100 containers in 124 key groups on the stand-in), built
   once as ``Roaring64Bitmap``s and once as ``Roaring64NavigableMap``s (set-up,
   timed apart); ``FastAggregation64.or_`` / ``xor`` / ``or_cardinality`` and
   ``or_navigable`` with ``mode="device"``, each against numpy and the
   port's 32-bit ``FastAggregation`` over each quarter's buckets (with the
   bucket added); ``benchmarks/aggregation64.py``'s 64 bitmaps, device
   against the CPU fold's bytes; the cold OR's stages
   (``_group_by_key64``, payload build, pinned staging, copy,
   ``rb_expand_rows``, reduce, result copy, trie rebuild), cold (median of
   5) and warm (median of 10) walls of ``FastAggregation64.or_`` and
   ``or_navigable`` in turns, both profiled (device idle share), peak
   device memory; (b) the BSI north star at 64 bits: 100,000,000 columns
   at ``2^33 + arange`` (50,000,000 in the whole script, to keep it
   inside its time), values uniform in [0, 2^48) from the seed (48
   slices, 1526 high-48 chunks), built through ``set_values`` (timed
   apart); phase 6's nine queries scaled to these values and a GE near the
   max (at least 2^47), ``compare`` and ``compare_cardinality`` each
   against numpy, ``compare_cardinality_many`` over 64 quantiles against
   ``np.searchsorted`` (one ``rb_oneil_counts`` launch); the first query,
   the steady kernels on the resident pack beside their bounds, the
   compare's stages, the steady ``compare`` median, batched ns per query,
   peak device memory. The launch counts are zeroed before the phase and
   read after its checked calls; the phase fails if ``rb_group_reduce``,
   ``rb_oneil_compare`` or ``rb_oneil_counts`` read 0.

15. (run after phase 14) multi-device through ``parallel/sharding.py``:
   (a) an NCCL world of 1 on the card over a local store, mesh (1, 1):
   with the ``mesh`` knob of the aggregation, BSI and 64-bit BSI configs
   set, ``FastAggregation.or_`` / ``and_`` / ``xor`` and the three
   cardinalities over the census set (built anew), Q1 through the planner
   (its OR steps must read ``device-or-sharded``), phase 6's index's
   ``compare`` for GE, LT, EQ, NEQ and RANGE and with a found set,
   ``compare_cardinality``, ``sum`` and ``compare_cardinality_many`` over
   64 quantiles, and phase 14's 64-bit batched count, each equal to the
   unsharded path and numpy; the five programs on full-size inputs made
   on the card from the seed (``[31, 10000, 2048]``, ``[32, 1526,
   2048]``, Q = 64) against the unsharded kernels; the launch counts
   zeroed before those calls and read after (``launches_mesh``); each
   route's wall, sharded and unsharded in turns (median of 3), and the
   sharded warm OR's and ``compare``'s idle share; (b) a gloo world of
   four processes of this script sharing ``cuda:0`` (``--mesh-rank``),
   mesh (2, 2), so every kernel runs at 1024 words, the collectives'
   partials copied to host memory for gloo: the five programs on the same
   seeded inputs and ``FastAggregation.or_`` over the census set through
   the mesh, every rank held to (a)'s answers; a rank that fails, or is
   still running after 300 s, fails the phase. With ``--only mesh`` both
   BSI indexes are cut to 10M rows.

16. (run after phase 5, on the census working set before phase 8 mutates
   it) the instrumentation and the fault model on the main path at full
   size: (a) the cold and warm ``FastAggregation.or_`` and Q1 with the
   timeline off (the reference bytes), then ``on``, then ``fenced``: the
   bytes equal to the off run and to numpy, every ``agg.dispatch``
   decision ``device`` and resolved in the outcome ledger with its wall,
   the recorder holding the pack, expansion, reduce, ladder and query
   spans, its Chrome trace parsed; the launch counts zeroed before the on
   and fenced runs and read after (``launches_observe``), equal to the
   deltas of ``rb_tpu_kernel_dispatch_total{engine="cuda"}``, with every
   kernel of the path launched; ``rb_tpu_compile_total`` unchanged over
   the window; (b) the warm OR with the timeline off / on / fenced in
   turns (median of 10) and the cold OR off against on (median of 5); (c)
   a ``tracing.trace`` window over three warm ORs with the timeline on:
   the span ``agg.device`` and an ``annotate`` range
   present, ``group_reduce_kernel`` and ``popcount_rows_kernel`` with
   device time, the idle share (CUDA events around the kernel wrappers
   where the profiler shows no device time); (d) faults on the card: a
   transient ``store.ship`` fault retried and counted recovered with the
   bytes exact, a ``simulated_oom`` at ``store.expand`` raising with no
   answer, and a real ``torch.cuda.OutOfMemoryError`` classified
   ``"resource"``.

17. (run after phase 16, on the same census working set) the rest of
   observe at full size, every launch counted (``launches_observatory``):
   (a) a cold wide OR with the 2.52 GB pack kept resident, then
   ``store.hbm_reconciliation()``: ledger drift 0, device drift (the
   resident entries' bytes minus ``torch.cuda.memory_allocated``) at or
   below 0, the gauge equal to the entries' bytes; ``PACK_CACHE.close()``
   takes the gauge to 0 and frees at least those bytes on the card; the
   JAX rule's reading beside the port's; (b) the health sentinel armed
   inline (interval 0) over warm ORs and Q1: the bytes equal, ticks
   counted, every rule green with the pack resident; the warm OR off
   against armed in turns (median of 10) and one ``tick()`` alone (median
   of 20); (c) ``store.ship`` faults open the device breaker, the sentinel
   on an injected clock goes red on ``breaker-stuck-open`` and writes one
   flight bundle into a temporary sink, verified by
   ``read_manifest(verify=True)``, its sections the ported set and its
   ``observatory.json`` holding the reconciliation's device keys; (d)
   ``lockstats.install()`` over the warm OR, Q1, ``ParallelAggregation``
   and a window of 8 fused queries: bytes equal, the six locks installed
   and timed; (e) the routed facade over the first 2,000 run-optimized
   census pairs against the device tier, with ``columnar.cutoff``
   decisions recorded and joined, ``rows_resident`` equal to the
   ``colrows`` entries and bytes, a transient ``columnar.device`` fault
   retried on the card with the result equal, a ``columnar.kernel`` fault
   raised and classified transient; (f) the structure ledger's census of
   the 10,000 bitmaps equal to a host count by container type; (g) a
   census facet count and a 320 x 10,000 all-pairs matrix under their
   ``batch.*`` spans, ``rb_tpu_batch_pairwise_total`` moving. Phase 17
   snapshots every pricing authority's state and the dispatcher's device
   gate before it starts and restores them after: it fails if either
   stays changed (its armed sentinel may refit, and (e) calibrates).

18. (run after phase 11, on the same census working set) the cost facade
   and the serving read path, every launch counted
   (``launches_tenants``): (a) ``FastAggregation.or_`` over census
   prefixes of about 60 to 7,900 containers, ``mode="device"`` and
   ``mode="cpu"`` in turns, every result against numpy, then
   ``breakeven.MODEL.refit_from_outcomes()``: both curves and the measured
   gate printed (None is a finding); (b) a pack-cache budget of 1.5 census
   halves, the halves' ORs evicting each other, the residency refit's
   learned ``repack_s`` for ``agg`` beside the next eviction's
   ``est_us.repack`` and the re-pack wall it then measures; (c) the load
   harness, 8 threads, closed loop, 200 requests of three declared
   tenants (interactive on ``default_mix``; a batch tenant of Q1-shaped
   queries over phase 8's A, B, C; a low quota), every served result
   equal to ``run_serial`` byte for byte, sheds only for the quota
   tenant and all ``ShedRejection``, hedged solo dispatches for the
   interactive tenant, per-tenant p50/p99 of queue and execute, the three
   serving rules reading values, per-tenant byte shares, a ``query.hedge``
   fault through the window with the same bytes and a ``serve.admit``
   fault admitting; (d) a seeded ``costmodel-drift`` making a sentinel run
   ``refit_all`` (a report per authority, no error) and write a red
   bundle whose ``calibration.json`` lists the eight authorities,
   ``serving-p99-pressure`` running ``autotune_window`` to shrink and
   regrow the window, and ``save_state`` / ``load_state`` round-tripping
   on the card with the breakeven and residency states stamped
   ``"cuda"`` (``"cpu"``-stamped copies refused). The phase restores every
   authority and the device gate as it found them, and fails if either
   stays changed or if ``rb_expand_rows``, ``rb_group_reduce``,
   ``rb_popcount_rows`` or ``rb_threshold`` read 0 launches.

19. (run after phase 18, on clones of the census working set) the serving
   write path and the durable tier, the launches of its own path counted
   segment by segment (``launches_epochs``; the oracles and the checks
   between the segments are not counted): (a) an ``EpochStore`` over a clone of the 10,000
   bitmaps with phase 8's A, B, C and the whole set registered, pinned
   and warm on the card; the load harness, 8 threads, 200 requests of
   phase 18's two reader tenants and a writer tenant (``writes=1.0``,
   about a quarter of the requests (40 requests in the whole script), each a batch into a bitmap's
   existing chunk keys followed by the priced ``maybe_flip``), through
   ``LoadHarness(epoch_store=)``, every result equal to
   ``run_serial_epochs`` over a second clone; then, with the overlap lane
   on, three flips (one in the whole script) each started while a reader
   pinned to the old epoch runs Q1-shaped queries and queries over fresh
   subsets (which the lane stages) through ``execute_pipelined`` (four
   queries a reader; two in the whole script), every result equal to its
   epoch's oracle; a flip behind a reader whose device copy of the whole
   set's rows, queued on a side stream behind a device sleep, is still in
   flight when its pin is released: the copy must hold the old epoch's
   rows and the flip must patch them; every flip must take the delta
   route (no full repack);
   the flips' delta records, the four flip stage walls, freshness p50 /
   p99 and each tenant's p99s; (b) ``maintain.run_pass(force=True)`` over
   the watched corpus: 0 audit anomalies, the wide OR of A, B, C and the
   whole set unchanged bit for bit, the drift ratio lower, the reclaimed
   bytes and rewritten keys; (c) a ``DurableStore`` in a temporary
   directory: a persist with its artifact bytes, stage walls and the
   ``rb_tpu_serial_bytes_total`` delta, then a flip and a
   ``durable.persist`` fault at each of the five crash points, after
   each of which ``recover`` must find the last complete epoch (points
   1-4: the first persist's; point 5 follows the rename: the new one);
   the newest artifact truncated, which ``recover`` must skip as torn;
   (d) ``recover`` -> ``resume_store`` -> the census wide OR, equal to the
   corpus's OR when the recovered epoch was persisted; ``readmit`` of the
   whole set from the map and its first OR, the learned ``readmit_s``;
   under a budget of 1.5 mapped halves an eviction that demotes to the
   mapped rung (``rb_tpu_durable_demote_total{rung="mapped"}``, the
   ``demote-mapped`` decision); the recovery closed after the pack cache
   and the directory deleted. The phase restores every authority as it
   found them and fails if ``rb_expand_rows``, ``rb_group_reduce``,
   ``rb_popcount_rows`` or ``rb_threshold`` read 0 launches.

20. (run last; ``--only fuzz`` runs it after phases 1-2) the fuzz
   campaign of ``roaringbitmap_tpu_torch.fuzz`` on the card, its launches
   counted (``launches_fuzz``): (a) ``run_campaign(n, device="cuda")`` as
   shipped, each family's iterations and wall printed; (b) the same with
   ``aggregation.config.mode = "device"`` (fuzz-sized sets hold 1-4
   containers, below the auto gate), restored after, the crash family's
   children run with ``cuda``; (c) ``kernels.group_reduce`` swapped for a
   version that flips one bit of one output row, under which
   ``device-layouts-vs-cpu-engines(or)`` (3 iterations) must raise
   ``InvarianceFailure`` whose base64 repro rebuilds one of the seed's
   working sets; the wrapper is restored. ``n`` is 200 with ``--only
   fuzz`` and 16 in the whole script, the least count at which
   ``rb_group_reduce`` dense and CSR, ``rb_popcount_rows``,
   ``rb_expand_rows``, ``rb_threshold`` and ``rb_oneil_counts`` (launch key
   ``rb_oneil_compare[batched]``) all launch; the phase fails if one reads
   0.

Every profiler window (``_profiled``) is a ``tracing.trace`` window; where
it shows no device events twice, the kernels are timed with CUDA events
around each kernel wrapper and the line says so.

The last lines are phase 19's launch counts (``{"launches_epochs": ...}``),
phase 20's (``{"launches_fuzz": ...}``),
a JSON object of the host tier's entry points
(``{"host_tier": [...]}``, each one's native and numpy ms; not with
``--only kernels``), a JSON object describing every kernel (``launches``
on its main path, ``launches_mapped`` on phase 13's, ``launches_64`` on
phase 14's, ``launches_mesh`` on phase 15's, ``launches_observe`` on
phase 16's, ``launches_observatory`` on phase 17's, ``launches_tenants`` on
phase 18's, ``launches_epochs`` on phase 19's, ``launches_fuzz`` on phase
20's; a ``name@1024`` row is the
kernel at 1024 words, whose path is phase 15 (b), its counts summed over
the ranks) and the JSON result ``{"ok": true, "device": {...}}``; with
``--only sixtyfour`` the phase's launch counts (``{"launches_64": ...}``)
and the JSON result; with ``--only mesh`` phase 15 (a)'s launch counts
and the 1024-word rows, then the JSON result; with ``--only observe``
phase 16's and 17's launch counts (``{"launches_observe": ...,
"launches_observatory": ...}``) and the JSON result; with ``--only tenants``
phase 18's launch counts (``{"launches_tenants": ...}``) and the JSON
result; with ``--only epochs`` phase 19's launch counts
(``{"launches_epochs": ...}``) and the JSON result; with ``--only fuzz``
phase 20's launch counts (``{"launches_fuzz": ...}``) and the JSON result.
The port needs no JAX
and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import gc
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0xFEEF1F0
N_BITMAPS = 10_000  # bench.py's working set
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (NVIDIA data sheet)
# host link, one direction: PCIe Gen5 x16, 128 GB/s both ways together
# (NVIDIA H100 data sheet)
PCIE_BYTES_PER_S = 64e9
ROW_BYTES = 2048 * 4
G_MAIN, M_MAIN, ROWS_MAIN = 31, 10_000, 308_100  # the main path's shapes
BSI_ROWS = 100_000_000  # BASELINE.md config 4, benchmarks/bsi.py:100-197
S_BSI, K_BSI = 32, (BSI_ROWS + 65535) // 65536  # [32, 1526, 2048] slices
RANGE_ROWS = 10_000_000
WIDE_ROWS = 131_072  # 1 GiB: the size the TPU sweep judged the wide kernel at
BATCH_Q = 64
# logic instructions per row word a carry-save adder needs for the
# bit-sliced counter (worked out from the adder's gates, not timed)
THRESHOLD_OPS_PER_WORD = 5
THRESHOLD_KS = (64, 200)
AGGREGATION_KERNELS = (
    "rb_group_reduce[dense]", "rb_group_reduce[csr]", "rb_group_reduce[rowmap]",
    "rb_popcount_rows", "rb_expand_rows",
)
REPS = 20
E2E_RUNS = 10  # end-to-end runs per median: the pass is host-bound and noisy
# logic instructions (LOP3) an SM issues per clock on the H100: 64 INT32
# lanes (NVIDIA Hopper architecture white paper)
LOGIC_LANES_PER_SM = 64
# logic instructions a column needs, for each 32 slices, in a formulation
# of the batched count that rebuilds each column's value (a 32 x 32 bit
# transpose) and ranks it among the sorted thresholds into a per-tile
# histogram of 2Q + 1 bins: about 20 whatever Q is (worked out from the
# instruction counts, not timed)
RANK_OPS_PER_COLUMN = 20
PAIR_OPS = ("and", "or", "xor", "andnot")
PAIR_ROWS_N = 150_000  # index pairs of the phase-3 rb_pair_rows check
# upstream's realdata pairwise benchmarks walk adjacent pairs of the corpus
# (jmh RealDataBenchmarkAnd/Or/Xor/AndNot); "and2by2" is its first 199.
# The window is cut from the 9,999 adjacent pairs to 2,000 to keep the
# script within about two minutes of its earlier time (the host's container
# build takes most of each op); --window-pairs 9999 runs them all
WINDOW_PAIRS = 2_000
FACADE_PAIRS = 199
SYNTH_NS = (64, 4096)  # bitmap-heavy pairs: 4096 is the routing window's edge
COLUMNAR_RUNS = 3  # runs per median of the window's timings
FACADE_RUNS = 5  # runs behind each pair's median in the facade's timings, the tiers taking turns
# the routed facade may be at most this much slower than the per-container
# walk it replaces (PERF.md section 2's limit for the facade's ns per pair)
FACADE_LIMIT = 1.35
SWEEP_Q = (8, 64, 256)  # the tiled walk against the per-query design
CHECK_Q = (8, 13, 64, 100, 256)  # bitwise checks of the tiled walk, every op
ONEIL_OPS = ("EQ", "NEQ", "GT", "LT", "LE", "GE", "RANGE")


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


def smi_clocks() -> str:
    """The SM clock, its maximum, the power draw and the power limit, as
    ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    )
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not measured"


def _mhz(field: str) -> float:
    return float(field.strip().split()[0])


def oneil_word_ops(bits: np.ndarray) -> int:
    """Logic instructions the tiled walk spends per column word for
    predicate bits int [Q, W, S], summed over the queries: one per walk and
    slice (a carry step, or an EQ step), whatever the bits are. This is the
    design's own floor, not what the function needs."""
    return int(np.prod(bits.shape))


def ops_bound_ms(word_ops: int, n_keys: int, mhz: float) -> float:
    """Least time for ``word_ops`` logic instructions on each of the K * 2048
    column words at the card's logic rate (SMs x 64 lanes x SM clock)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return word_ops * n_keys * 2048 / (sms * LOGIC_LANES_PER_SM * mhz * 1e6) * 1e3


def batched_bound(s_count: int, k: int, q_n: int, fixed_is_ebm: bool, mhz: float,
                  row_words: int = 2048):
    """The batched count's bound, from what the function needs rather than
    what the walk does: (ms, "bytes" or "operations", byte bound, operation
    bound). Bytes: the slices, ebm and fixed read once and the [Q, K] cards
    written once. Operations: RANK_OPS_PER_COLUMN logic instructions a
    column for each 32 slices, whatever Q is. Rows of ``row_words`` words."""
    b_bytes = bound_ms(_oneil_bytes(s_count, k, q_n, fixed_is_ebm, True, row_words * 4))
    b_ops = ops_bound_ms(RANK_OPS_PER_COLUMN * 32 * -(-s_count // 32), k * row_words / 2048, mhz)
    return max(b_bytes, b_ops), "operations" if b_ops > b_bytes else "bytes", b_bytes, b_ops


def max_sm_mhz() -> float:
    """The SM clock's maximum as ``nvidia-smi`` gives it (1980 MHz on the
    H100 SXM where it cannot be read)."""
    fields = smi_clocks().split(",")
    return _mhz(fields[1]) if len(fields) == 4 else 1980.0


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
    sec = _build.BUILD_SECONDS
    compiles = {k: v for k, v in sec.items() if k not in ("link", "wall")}
    say(
        "[build] nvcc " + ", ".join(f"{k} {v:.2f} s" for k, v in compiles.items())
        + f" (started together), link {sec['link']:.2f} s: build {sec['wall']:.2f} s, "
        f"against {sum(compiles.values()) + sec['link']:.2f} s for the same compiles one after the other"
    )
    for line in log.splitlines():
        if any(k in line for k in ("registers", "spill", "Compiling entry", "error", "warning")):
            say(f"[build] {line.strip()}")
    lib = _build.load()
    regs, smem = ctypes.c_int(), ctypes.c_int()
    _build.check(lib, lib.rb_pairwise_and_card_attrs(0, ctypes.byref(regs), ctypes.byref(smem)),
                 "rb_pairwise_and_card_attrs")
    say(f"[build] rb_pairwise_and_card: {regs.value} registers a thread (setmaxnreg then moves them: "
        f"producer 40, consumers 232), {smem.value} bytes of dynamic shared memory (4 stages of 48 KB, "
        f"1 KB alignment, 8 mbarriers), 384 threads")
    say(f"[build] {sass_slice_loop(path)}")
    build_host_tier()


def build_host_tier():
    """g++ of the native host tier (both bindings, compiled anew), with the
    compiler's version, the seconds, the tier's state and the CPU."""
    from roaringbitmap_tpu_torch import native

    t0 = time.perf_counter()
    paths = native.build(force=True)
    native.load()
    t_host = time.perf_counter() - t0
    gxx = native.build_commands()["ctypes"][0][0]
    version = subprocess.run([gxx, "--version"], capture_output=True, text=True, timeout=60).stdout
    sec = native.BUILD_SECONDS
    say(
        f"[build] host tier: {version.splitlines()[0] if version else gxx}; g++ "
        + ", ".join(f"{k} {v:.2f} s" for k, v in sec.items() if k != "wall")
        + f" (started together), build {sec['wall']:.2f} s, build and load {t_host:.2f} s: "
        + ", ".join(p.name for p in paths.values())
        + f"; backend_tier() {native.backend_tier()}; OpenMP threads {native.omp_threads()}; "
        f"CPU {_cpu_model()}"
    )


# the tiled walk's GE instance and the shape of its slice loop (oneil.cu:
# kUnroll slices x kGroupWalks walks x kVec words per pass)
_TILED_GE = "oneil_tiled_kernelILi5E"
_LOOP_WORD_STEPS = 4 * 16 * 4


def sass_slice_loop(lib_path) -> str:
    """Instruction counts of the tiled GE walk's innermost loop that loads
    slices (the smallest backward branch whose range holds an LDS.128), from
    ``cuobjdump -sass`` of the built library, and the issue slots and logic
    instructions per word-step they imply (the loop has no branch inside:
    every instruction in it issues once a pass)."""
    import re
    from pathlib import Path

    from roaringbitmap_tpu_torch.ops import _build

    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    if not tool.is_file():
        return "SASS count of the slice loop: not measured (no cuobjdump)"
    dump = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True)
    text = dump.stdout
    start = text.find(_TILED_GE)
    if dump.returncode != 0 or start < 0:
        return "SASS count of the slice loop: not measured (cuobjdump found no tiled kernel)"
    end = text.find("Function :", start)
    inst = []  # (address, opcode, text)
    for line in text[start:end if end > 0 else len(text)].splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*);", line)
        if m:
            inst.append((int(m.group(1), 16), m.group(3), m.group(3) + m.group(4)))
    loops = []
    for addr, opc, txt in inst:
        t = re.search(r"BRA(?:\.[A-Z.]+)?\s+(0x[0-9a-f]+)", txt)
        if opc.startswith("BRA") and t and int(t.group(1), 16) < addr:
            body = [x for x in inst if int(t.group(1), 16) <= x[0] <= addr]
            if any(x[1].startswith("LDS.128") for x in body):
                loops.append(body)
    if not loops:
        return "SASS count of the slice loop: not measured (no loop loads the tile)"
    body = min(loops, key=len)
    counts = {}
    for _, opc, _ in body:
        key = opc.split(".")[0]
        counts[key] = counts.get(key, 0) + 1
    lop3 = counts.get("LOP3", 0)
    top = ", ".join(f"{k} {v}" for k, v in sorted(counts.items(), key=lambda kv: -kv[1]))
    return (
        f"SASS of the tiled GE walk's slice loop ({_LOOP_WORD_STEPS} word-steps a pass: 4 slices x "
        f"16 walks x 4 words): {len(body)} instructions ({top}); {len(body) / _LOOP_WORD_STEPS:.2f} "
        f"issue slots and {lop3 / _LOOP_WORD_STEPS:.2f} logic instructions per word-step"
    )


# ---------------------------------------------------------------------------
# phase 3: kernels against plain versions
# ---------------------------------------------------------------------------


def _rand_dense(gen, shape) -> torch.Tensor:
    """Random int32 words on the card with all 32 bits in play (``random_``
    alone never sets the sign bit)."""
    a = torch.empty(shape, dtype=torch.int32, device="cuda").random_(generator=gen)
    b = torch.empty(shape, dtype=torch.int32, device="cuda").random_(generator=gen)
    return a ^ (b << 1)


def _rand_words(gen, n_words: int, op: str, density: float = 0.0022) -> torch.Tensor:
    """Words whose or/and/xor over ~10,000 rows (at the default density)
    keeps about half the bits set: sparse single bits for or, their
    complement for and, dense random words for xor."""
    if op == "xor":
        return _rand_dense(gen, n_words)
    w = torch.zeros(n_words, dtype=torch.int32, device="cuda")
    nnz = int(n_words * density)
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


def phase_pair_rows(card: str):
    """``rb_pair_rows`` against ``pair_rows_reduce_plain`` for every op on
    random words over ``[308100, 2048]`` rows (the main path's row count)
    and 150,000 random index pairs into them, repeats and the last row
    included; one launch per call, bitwise equal words and cards."""
    from roaringbitmap_tpu_torch.ops import kernels as K

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    rng = np.random.default_rng(SEED + 6)
    rows = _rand_dense(gen, (ROWS_MAIN, 2048))
    ia = rng.integers(0, ROWS_MAIN, PAIR_ROWS_N)
    ib = rng.integers(0, ROWS_MAIN, PAIR_ROWS_N)
    ia[:3] = ROWS_MAIN - 1
    ib[-3:] = ROWS_MAIN - 1
    ia[100:200] = ia[:100]  # a run of repeated pairs
    ib[100:200] = ib[:100]
    ia_t = torch.from_numpy(ia.astype(np.int32)).cuda()
    ib_t = torch.from_numpy(ib.astype(np.int32)).cuda()
    # the least the card must move: each distinct row read once (both
    # streams index the one block), every result row and card written, the
    # two index streams read
    distinct = int(np.unique(np.concatenate([ia, ib])).size)
    nbytes = distinct * ROW_BYTES + PAIR_ROWS_N * (ROW_BYTES + 4 + 8)
    b = bound_ms(nbytes)
    out, errs = {}, []
    for op in PAIR_OPS:
        before = K.LAUNCHES["rb_pair_rows"]
        got = K.pair_rows_reduce(rows, ia_t, rows, ib_t, op)
        torch.cuda.synchronize()
        if K.LAUNCHES["rb_pair_rows"] != before + 1:
            fail(f"rb_pair_rows {op}: launches went {before} -> {K.LAUNCHES['rb_pair_rows']}")
        want = K.pair_rows_reduce_plain(rows, ia_t, rows, ib_t, op)
        errs.append(max(_compare(f"rb_pair_rows {op} words", got[0], want[0]),
                        _compare(f"rb_pair_rows {op} cards", got[1], want[1])))
        bits_set = int(want[1].long().sum())
        if not 0 < bits_set < PAIR_ROWS_N * 65536:
            fail(f"rb_pair_rows {op}: the plain answer has {bits_set} bits")
        del got, want
        ms = cuda_ms(lambda: K.pair_rows_reduce(rows, ia_t, rows, ib_t, op))
        plain = cuda_ms(lambda: K.pair_rows_reduce_plain(rows, ia_t, rows, ib_t, op), reps=3, warmup=1)
        say(
            f"[kernel] rb_pair_rows {op} [{ROWS_MAIN}, 2048] x {PAIR_ROWS_N} pairs ({distinct} distinct "
            f"rows): equal ({bits_set} result bits); {ms:.4f} ms, bound {b:.4f} ms ({nbytes} bytes; "
            f"{b / ms:.1%} of bound), plain {plain:.3f} ms; library call: none  [{card}]"
        )
        if op == "or":  # the op of the window's launch on the main path
            out["rb_pair_rows"] = dict(
                replaces="roaringbitmap_tpu/ops/pallas_kernels.py:985", ms=ms, plain_ms=plain,
                bound_ms=b, bound_by="bytes",
            )
    out["rb_pair_rows"]["max_abs_err"] = max(errs)
    del rows
    torch.cuda.empty_cache()
    return out


def _bits_tensor(walks) -> torch.Tensor:
    """int32 [Q, W, S] predicate bits (highest slice first) on the card from
    Q lists of W predicate values; S is S_BSI unless the lists say more."""
    return torch.tensor(walks, dtype=torch.int32, device="cuda")


def _pred_bits(value: int, s_count: int):
    return [(value >> i) & 1 for i in range(s_count - 1, -1, -1)]


def _oneil_bytes(s_count, k, q_n, fixed_is_ebm, count_only, row_bytes=ROW_BYTES):
    """Bytes ``rb_oneil_compare`` must move: the slices, the ebm and (when
    it is another tensor) fixed read once, the result words (unless
    count-only) and the [Q, K] cards written once."""
    kw = k * row_bytes
    return s_count * kw + (1 if fixed_is_ebm else 2) * kw + (0 if count_only else kw) + q_n * k * 4


def _near_slices(gen, value: int, s_count: int, ebm: torch.Tensor, sparsity: int) -> torch.Tensor:
    """[S, K, 2048] slices (within the ebm) whose columns hold ``value``
    with each bit flipped with probability 2**-sparsity: about
    (1 - 2**-sparsity)**S of the columns equal ``value`` and the rest lie on
    both sides of it, so every op's answer has many set bits and many clear
    ones. The walk is branch-free: its time does not depend on the data."""
    out = torch.empty((s_count, *ebm.shape), dtype=torch.int32, device="cuda")
    for i in range(s_count):
        flip = _rand_dense(gen, ebm.shape)
        for _ in range(sparsity - 1):
            flip &= _rand_dense(gen, ebm.shape)
        out[i] = (flip ^ -((value >> i) & 1)) & ebm
    return out


def _oneil_case(K, card, name, slices, bits, ebm, fixed, op, count_only):
    got = K.oneil_compare(slices, bits, ebm, fixed, op, count_only)
    want = K.oneil_compare_plain(slices, bits, ebm, fixed, op, count_only)
    err = _compare(f"{name} cards", got[1], want[1])
    if not count_only:
        err = max(err, _compare(f"{name} words", got[0], want[0]))
    # the check is only as strong as the answer: one that is empty or all
    # of ``fixed`` would also pass for a kernel with a wrong epilogue
    hits, q_n = int(want[1].long().sum()), bits.shape[0]
    if not 0 < hits < q_n * int(K.popcount_rows(fixed).long().sum()):
        fail(f"{name}: the plain answer has {hits} bits; the inputs do not test the op")
    ms = cuda_ms(lambda: K.oneil_compare(slices, bits, ebm, fixed, op, count_only))
    plain = cuda_ms(
        lambda: K.oneil_compare_plain(slices, bits, ebm, fixed, op, count_only), reps=3, warmup=1
    )
    nbytes = _oneil_bytes(
        slices.shape[0], slices.shape[1], q_n, fixed.data_ptr() == ebm.data_ptr(), count_only,
        slices.shape[2] * 4,
    )
    b = bound_ms(nbytes)
    say(
        f"[kernel] {name}: equal ({hits} result bits); {ms:.4f} ms, bound {b:.4f} ms "
        f"({nbytes} bytes; {b / ms:.1%} of bound), plain {plain:.3f} ms; library call: none  [{card}]"
    )
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b)


def _thresholds(rng, pred: int, q_n: int):
    """q_n thresholds drawn like the phase-3 values (pred with each bit
    flipped with probability 1/32), sorted."""
    flips = np.bitwise_and.reduce(rng.integers(0, 1 << 32, size=(5, q_n), dtype=np.uint64), axis=0)
    return [int(v) for v in np.sort(np.uint64(pred) ^ flips)]


def _walks(op: str, qs, s_count: int, span: int = 1 << 20):
    """int32 [Q, W, S] predicate bits for thresholds ``qs`` (RANGE: each
    threshold to threshold + span, capped at the largest value)."""
    cap = (1 << s_count) - 1
    if op == "RANGE":
        return [[_pred_bits(q, s_count), _pred_bits(min(q + span, cap), s_count)] for q in qs]
    return [[_pred_bits(q, s_count)] for q in qs]


def phase_tiled_walk(K, card: str, slices, ebm, found, pred: int):
    """The tiled count-only walk (``rb_oneil_counts``): bitwise against the
    plain version for every op at Q in CHECK_Q, with and without a found
    set; timed against the per-query design (``oneil_counts_per_query``)
    in the same call at Q in SWEEP_Q, each beside its byte bound and its
    operation bound; and a batch past the tile's depth limit, which must
    run on the per-query kernel."""
    rng = np.random.default_rng(SEED + 3)
    s_count, k = slices.shape[0], slices.shape[1]
    fixed_bits = int(K.popcount_rows(found).long().sum())
    ebm_bits = int(K.popcount_rows(ebm).long().sum())
    for q_n in CHECK_Q:
        qs = _thresholds(rng, pred, q_n)
        for op in ONEIL_OPS:
            bits = _bits_tensor(_walks(op, qs, s_count))
            for fixed, label, full in ((ebm, "no found set", ebm_bits), (found, "a found set", fixed_bits)):
                before = K.LAUNCHES["rb_oneil_compare[batched]"]
                got = K.oneil_compare(slices, bits, ebm, fixed, op, True)[1]
                torch.cuda.synchronize()
                if K.LAUNCHES["rb_oneil_compare[batched]"] != before + 1:
                    fail(f"tiled walk {op} Q={q_n}: launches {K.LAUNCHES}")
                want = K.oneil_compare_plain(slices, bits, ebm, fixed, op, True)[1]
                _compare(f"rb_oneil_compare[batched] {op} Q={q_n} with {label}", got, want)
                hits = int(want.long().sum())
                if not 0 < hits < q_n * full:
                    fail(f"tiled walk {op} Q={q_n} with {label}: the plain answer has {hits} bits")
        say(f"[kernel] rb_oneil_compare[batched] Q={q_n}: all 7 ops equal to the plain version, "
            f"with and without a found set  [{card}]")

    out = {}
    mhz_max = max_sm_mhz()
    for q_n in SWEEP_Q:
        qs = _thresholds(rng, pred, q_n)
        bits = _bits_tensor(_walks("GE", qs, s_count))
        tiled = K.oneil_compare(slices, bits, ebm, ebm, "GE", True)[1]
        per_query = K.oneil_counts_per_query(slices, bits, ebm, ebm, "GE")
        want = K.oneil_compare_plain(slices, bits, ebm, ebm, "GE", True)[1]
        err = max(_compare(f"tiled walk GE Q={q_n}", tiled, want),
                  _compare(f"per-query walk GE Q={q_n}", per_query, want))
        # in turns: per-query, tiled, tiled, per-query
        pq1 = cuda_ms(lambda: K.oneil_counts_per_query(slices, bits, ebm, ebm, "GE"))
        t1 = cuda_ms(lambda: K.oneil_compare(slices, bits, ebm, ebm, "GE", True))
        t2 = cuda_ms(lambda: K.oneil_compare(slices, bits, ebm, ebm, "GE", True))
        pq2 = cuda_ms(lambda: K.oneil_counts_per_query(slices, bits, ebm, ebm, "GE"))
        # the SM clock beside a window of tiled launches
        torch.cuda.synchronize()
        for _ in range(max(20, int(300 / max(t1, 0.05)))):
            K.oneil_compare(slices, bits, ebm, ebm, "GE", True)
        clocks = smi_clocks()
        torch.cuda.synchronize()
        ms, pq = min(t1, t2), min(pq1, pq2)
        b, by, b_bytes, b_ops = batched_bound(s_count, k, q_n, True, mhz_max)
        word_ops = oneil_word_ops(bits.cpu().numpy())
        walk = ops_bound_ms(word_ops, k, mhz_max)
        say(
            f"[kernel] tiled vs per-query GE count-only Q={q_n} [{s_count}, {k}, 2048]: equal; tiled "
            f"{t1:.4f} / {t2:.4f} ms ({ms / q_n:.5f} ms per query), per-query {pq1:.4f} / {pq2:.4f} ms "
            f"({pq / q_n:.5f} per query), {pq / ms:.2f}x; byte bound {b_bytes:.4f} ms, operation bound "
            f"{b_ops:.4f} ms ({RANK_OPS_PER_COLUMN} logic instructions a column, whatever Q is, at the "
            f"{mhz_max:.0f} MHz maximum SM clock): {by} bind, {b / ms:.1%} of the bound; the walk's own "
            f"floor {walk:.4f} ms ({word_ops / (q_n * s_count):.4f} logic instructions per word-step): "
            f"{walk / ms:.1%} of it; clocks.sm, clocks.max.sm, power.draw, power.limit beside the "
            f"window: {clocks}  [{card}]"
        )
        if q_n == BATCH_Q:
            plain = cuda_ms(
                lambda: K.oneil_compare_plain(slices, bits, ebm, ebm, "GE", True), reps=3, warmup=1)
            out["rb_oneil_compare[batched]"] = dict(
                replaces="roaringbitmap_tpu/models/bsi.py:974", max_abs_err=err, ms=ms,
                plain_ms=plain, bound_ms=b, bound_by=by)
            if not ms < pq:
                fail(f"the tiled walk ({ms:.4f} ms) is not faster than the per-query design ({pq:.4f} ms)")

    # past the tile's depth limit the batch runs on the per-query kernel
    deep, kd = K.MAX_TILED_SLICES + 9, 64
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    big = (1 << (deep - 1)) | 0x9E3779B97F4A7C15
    ebm_d = ebm[:kd].contiguous()
    slices_d = _near_slices(gen, big, deep, ebm_d, 6)
    found_d = found[:kd].contiguous()
    found_bits = int(K.popcount_rows(found_d).long().sum())
    for op, qs in (("GE", [big ^ (1 << i) for i in range(0, 8 * 50, 50)]),
                   ("RANGE", [big ^ (1 << i) for i in range(0, 8 * 50, 50)]),
                   ("GE", [big ^ (1 << i) for i in range(0, 6 * BATCH_Q, 6)])):
        bits = _bits_tensor(_walks(op, qs, deep, span=1 << 200))
        before = dict(K.LAUNCHES)
        got = K.oneil_compare(slices_d, bits, ebm_d, found_d, op, True)[1]
        torch.cuda.synchronize()
        if K.LAUNCHES != {**before, "rb_oneil_compare[batched-deep]": before["rb_oneil_compare[batched-deep]"] + 1}:
            fail(f"{deep} slices did not run on the per-query kernel: {K.LAUNCHES}")
        want = K.oneil_compare_plain(slices_d, bits, ebm_d, found_d, op, True)[1]
        err = _compare(f"rb_oneil_compare[batched-deep] {op} Q={len(qs)} [{deep}, {kd}, 2048]", got, want)
        hits = int(want.long().sum())
        if not 0 < hits < len(qs) * found_bits:
            fail(f"deep {op}: the plain answer has {hits} bits; the inputs do not test the op")
        say(f"[kernel] rb_oneil_compare[batched-deep] {op} Q={len(qs)} [{deep}, {kd}, 2048] "
            f"(past the tiled walk's {K.MAX_TILED_SLICES} slices): equal ({hits} result bits)  [{card}]")
    # the deep path's row: the last batch, GE over BATCH_Q thresholds
    ms = cuda_ms(lambda: K.oneil_compare(slices_d, bits, ebm_d, found_d, "GE", True))
    plain = cuda_ms(lambda: K.oneil_compare_plain(slices_d, bits, ebm_d, found_d, "GE", True), reps=3, warmup=1)
    b, by, b_bytes, b_ops = batched_bound(deep, kd, BATCH_Q, False, mhz_max)
    say(
        f"[kernel] rb_oneil_compare[batched-deep] GE count-only Q={BATCH_Q} [{deep}, {kd}, 2048] with a "
        f"found set: {ms:.4f} ms ({ms / BATCH_Q:.5f} ms per query); byte bound {b_bytes:.4f} ms, "
        f"operation bound {b_ops:.4f} ms: {by} bind, {b / ms:.1%} of the bound; plain {plain:.3f} ms; "
        f"library call: none  [{card}]"
    )
    out["rb_oneil_compare[batched-deep]"] = dict(
        replaces="roaringbitmap_tpu/models/bsi.py:974", max_abs_err=err, ms=ms, plain_ms=plain,
        bound_ms=b, bound_by=by)
    del slices_d
    torch.cuda.empty_cache()
    return out


def phase_bsi_kernels(card: str):
    """``rb_oneil_compare``, the masked popcount and the wide reduce against
    their plain versions at the BSI north star's shapes."""
    from roaringbitmap_tpu_torch.ops import kernels as K

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    results = {}
    W = 2048
    s_count, k = S_BSI, K_BSI
    # the north star's ebm: every column of 1526 chunks, the last one holding
    # 100,000,000 - 1525 * 65536 = 57,600 columns (words 0..1799)
    ebm = torch.full((k, W), -1, dtype=torch.int32, device="cuda")
    tail = BSI_ROWS - (k - 1) * 65536
    ebm[k - 1, tail // 32:] = 0
    # values near pred (each bit flipped with probability 1/32): ~36% of the
    # columns equal it, so EQ and NEQ are tested as hard as the others
    pred = 0x9E3779B9
    lo, hi = pred - (1 << 16), pred + (1 << 16)
    slices = _near_slices(gen, pred, s_count, ebm, 5)
    found = _rand_dense(gen, (k, W)) & _rand_dense(gen, (k, W)) & ebm  # ~25% of the ebm
    for op in ("EQ", "NEQ", "GT", "LT", "LE", "GE", "RANGE"):
        walks = [[_pred_bits(lo, s_count), _pred_bits(hi, s_count)]] if op == "RANGE" else [
            [_pred_bits(pred, s_count)]]
        _oneil_case(
            K, card, f"rb_oneil_compare {op} [{s_count}, {k}, 2048]", slices,
            _bits_tensor(walks), ebm, ebm, op, False,
        )
    _oneil_case(
        K, card, f"rb_oneil_compare EQ (again, after the other ops) [{s_count}, {k}, 2048]",
        slices, _bits_tensor([[_pred_bits(pred, s_count)]]), ebm, ebm, "EQ", False,
    )
    for op in ("EQ", "NEQ"):
        _oneil_case(
            K, card, f"rb_oneil_compare {op} with a found set [{s_count}, {k}, 2048]", slices,
            _bits_tensor([[_pred_bits(pred, s_count)]]), ebm, found, op, False,
        )
    # the kernel's entry: the general case, a found set other than the ebm
    r = _oneil_case(
        K, card, f"rb_oneil_compare GE with a found set [{s_count}, {k}, 2048]", slices,
        _bits_tensor([[_pred_bits(pred, s_count)]]), ebm, found, "GE", False,
    )
    results["rb_oneil_compare"] = dict(r, replaces="roaringbitmap_tpu/ops/pallas_kernels.py:699")
    # 64 thresholds drawn like the values (pred with bits flipped), so each
    # count splits the columns
    rng = np.random.default_rng(SEED + 2)
    flips = np.bitwise_and.reduce(rng.integers(0, 1 << 32, size=(5, BATCH_Q), dtype=np.uint64), axis=0)
    qs = np.sort(np.uint64(pred) ^ flips).tolist()
    r = _oneil_case(
        K, card, f"rb_oneil_compare[batched] GE count-only Q={BATCH_Q} [{s_count}, {k}, 2048]",
        slices, _bits_tensor([[_pred_bits(int(q), s_count)] for q in qs]), ebm, ebm, "GE", True,
    )
    say(
        f"[kernel] rb_oneil_compare[batched]: {r['ms'] / BATCH_Q:.4f} ms per query over "
        f"{BATCH_Q} queries; re-reading the slices once per query from device memory "
        f"would bound it at {bound_ms(BATCH_Q * s_count * k * ROW_BYTES):.4f} ms  [{card}]"
    )
    results.update(phase_tiled_walk(K, card, slices, ebm, found, pred))
    deep = 70
    big = (1 << 69) | 0x123456789ABCDEF
    slices70 = _near_slices(gen, big, deep, ebm, 6)  # ~33% of the columns equal big
    for op, walk in (("EQ", [_pred_bits(big, deep)]),
                     ("RANGE", [_pred_bits(big - (1 << 35), deep), _pred_bits(big + (1 << 35), deep)])):
        _oneil_case(
            K, card, f"rb_oneil_compare {op} [{deep}, {k}, 2048]", slices70,
            _bits_tensor([walk]), ebm, found, op, False,
        )
    del slices70
    torch.cuda.empty_cache()

    got = K.popcount_rows(slices, mask=found)
    want = K.popcount_rows_plain(slices, mask=found)
    err = _compare("rb_popcount_rows[masked]", got, want)
    ms = cuda_ms(lambda: K.popcount_rows(slices, mask=found))
    plain = cuda_ms(lambda: K.popcount_rows_plain(slices, mask=found), reps=3, warmup=1)
    kw = k * ROW_BYTES
    b = bound_ms(s_count * kw + kw + s_count * k * 4)
    say(
        f"[kernel] rb_popcount_rows[masked] [{s_count}, {k}, 2048] & [{k}, 2048]: equal; "
        f"{ms:.4f} ms, bound {b:.4f} ms ({b / ms:.1%} of bound), plain {plain:.3f} ms; "
        f"library call: none  [{card}]"
    )
    results["rb_popcount_rows[masked]"] = dict(
        replaces="roaringbitmap_tpu/models/bsi.py:1111", max_abs_err=err, ms=ms,
        plain_ms=plain, bound_ms=b,
    )
    del slices, found, ebm
    torch.cuda.empty_cache()

    n_words = WIDE_ROWS * W
    for op in ("or", "and", "xor"):
        # ~0.7 set bits per bit position over the 131,072 rows: about half
        # the result bits stay clear for or (set for and)
        words = _rand_words(gen, n_words, op, density=46_000 / n_words).view(WIDE_ROWS, W)
        red, crd = K.wide_reduce_cardinality(words, op)
        want_red, want_crd = K.wide_reduce_cardinality_plain(words, op)
        err = _compare(f"wide_reduce_cardinality {op}", red, want_red)
        err = max(err, _compare(f"wide_reduce_cardinality {op} card", crd.view(1), want_crd.view(1)))
        ms = cuda_ms(lambda: K.wide_reduce_cardinality(words, op))
        plain = cuda_ms(lambda: K.wide_reduce_cardinality_plain(words, op), reps=3, warmup=1)
        # the same rows as 1024 segments of 128: every chunk has its own
        # output row, so the difference is what the atomic combine into one
        # row costs
        split = K.SegmentPlan.dense(WIDE_ROWS // K.CHUNK_ROWS, K.CHUNK_ROWS)
        ms_split = cuda_ms(lambda: K.group_reduce(words, split, op))
        b = bound_ms(WIDE_ROWS * ROW_BYTES + ROW_BYTES + 4)
        say(
            f"[kernel] wide_reduce_cardinality {op} [{WIDE_ROWS}, 2048] "
            f"({WIDE_ROWS // K.CHUNK_ROWS} chunks into one row): equal (card {int(crd)}); "
            f"{ms:.4f} ms, bound {b:.4f} ms ({b / ms:.1%} of bound), plain {plain:.3f} ms; "
            f"the same rows reduced into {split.n_groups} rows without contention "
            f"{ms_split:.4f} ms (reduce only); library call: none  [{card}]"
        )
        if op == "or":
            results["wide_reduce_cardinality"] = dict(
                replaces="roaringbitmap_tpu/ops/pallas_kernels.py:314", max_abs_err=err,
                ms=ms, plain_ms=plain, bound_ms=b,
            )
        del words
        torch.cuda.empty_cache()
    return results


def _threshold_case(K, name, words3, k, n_slices):
    """``rb_threshold`` against ``threshold_rows_plain`` on the same block:
    exactly one launch, bitwise equal words and cards. Returns (max abs
    error, the plain answer's set bits)."""
    before = K.LAUNCHES["rb_threshold"]
    got = K.threshold_rows(words3, k, n_slices)
    torch.cuda.synchronize()
    if K.LAUNCHES["rb_threshold"] != before + 1:
        fail(f"{name}: rb_threshold launches went {before} -> {K.LAUNCHES['rb_threshold']}")
    want = K.threshold_rows_plain(words3, k, n_slices)
    err = max(_compare(f"{name} words", got[0], want[0]),
              _compare(f"{name} cards", got[1], want[1]))
    return err, int(want[1].long().sum())


def phase_threshold_kernel(card: str, bitmaps):
    """``rb_threshold`` on the zero-padded ``[31, 10000, 2048]`` block of
    the census working set's real rows (the block ``threshold(k, all
    10,000)`` runs on) at k = 64 and 200, and at an odd shape: G = 1, M =
    997 (not a power of two), k = 1500 past the 10-slice counter's width."""
    from roaringbitmap_tpu_torch.ops import kernels as K
    from roaringbitmap_tpu_torch.parallel import store

    packed = store.pack_groups(store.group_by_key(bitmaps), "cuda")
    words3 = packed.padded_device(0)
    g, m = words3.shape[0], words3.shape[1]
    if (g, m) != (G_MAIN, M_MAIN):
        fail(f"the census threshold block is [{g}, {m}, 2048], expected [{G_MAIN}, {M_MAIN}, 2048]")
    n_slices = max(1, m.bit_length())
    mhz = max_sm_mhz()
    out = {}
    b_bytes = bound_ms(g * m * ROW_BYTES + g * ROW_BYTES + g * 4)
    b_ops = ops_bound_ms(THRESHOLD_OPS_PER_WORD * m, g, mhz)
    ripple = ops_bound_ms(2 * n_slices * m, g, mhz)
    b, by = max(b_bytes, b_ops), "operations" if b_ops > b_bytes else "bytes"
    for k in THRESHOLD_KS:
        name = f"rb_threshold k={k} [{g}, {m}, 2048] (census rows, L={n_slices})"
        err, hits = _threshold_case(K, name, words3, k, n_slices)
        if not 0 < hits < g * 65536:
            fail(f"{name}: the plain answer has {hits} bits; the inputs do not test the compare")
        ms = cuda_ms(lambda: K.threshold_rows(words3, k, n_slices))
        plain = cuda_ms(lambda: K.threshold_rows_plain(words3, k, n_slices), reps=3, warmup=1)
        say(
            f"[kernel] {name}: equal ({hits} result bits); {ms:.4f} ms; byte bound {b_bytes:.4f} ms "
            f"(the block read once), operation bound {b_ops:.4f} ms ({THRESHOLD_OPS_PER_WORD} logic "
            f"instructions a row word, carry-save, at {mhz:.0f} MHz): {by} bind, {b / ms:.1%} of the "
            f"bound; a full ripple's {2 * n_slices} a row word would take {ripple:.4f} ms; plain "
            f"{plain:.3f} ms; library call: none  [{card}]"
        )
        if k == THRESHOLD_KS[0]:
            out["rb_threshold"] = dict(
                replaces="roaringbitmap_tpu/query/kernels.py:375", max_abs_err=err, ms=ms,
                plain_ms=plain, bound_ms=b, bound_by=by,
            )
    del packed, words3
    torch.cuda.empty_cache()
    # the odd shape: random words, each bit set with probability 1/2, so
    # counts near 498 (sd 16) straddle the compare on the low 10 bits of
    # 1500 (476)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    odd = _rand_dense(gen, (1, 997, 2048))
    k, n_slices = 1500, max(1, 997 .bit_length())
    if not k >> n_slices:
        fail("the odd shape's k is inside the counter's width")
    err, hits = _threshold_case(K, "rb_threshold odd shape", odd, k, n_slices)
    if not 0 < hits < 65536:
        fail(f"rb_threshold odd shape: the plain answer has {hits} bits")
    out["rb_threshold"]["max_abs_err"] = max(out["rb_threshold"]["max_abs_err"], err)
    say(f"[kernel] rb_threshold [1, 997, 2048] k={k} (k >> {n_slices} = {k >> n_slices}: the "
        f"kernel compares the low {n_slices} bits, as the JAX function does): equal ({hits} result "
        f"bits)  [{card}]")
    del odd
    torch.cuda.empty_cache()
    return out


def _edge_payload_containers():
    """The expansion's edge cases in the port's containers: adjacent runs
    (a stop on the next run's start bit), a run ending at 65535, the full
    run container, 2,047 runs in one container, a full 4,096-value array,
    array values on bits 0, 31, 32 and 65535, and bitmap rows."""
    from roaringbitmap_tpu_torch.models import container as tc

    rng = np.random.default_rng(SEED + 9)
    w = np.zeros(1024, np.uint64)
    for x in rng.choice(65536, 9000, replace=False):
        w[x >> 6] |= np.uint64(1) << np.uint64(x & 63)
    starts = np.arange(0, 65536, 32, dtype=np.int64)[:2047]
    lengths = np.full(2047, 15, dtype=np.int64)
    lengths[-1] = 65535 - starts[-1]
    u16 = lambda a: np.asarray(a, dtype=np.uint16)  # noqa: E731
    return [
        tc.RunContainer(u16([0, 10, 20, 31, 32, 96]), u16([9, 9, 10, 0, 63, 1000])),
        tc.RunContainer(u16([7, 65000]), u16([0, 535])),
        tc.RunContainer(u16([0]), u16([65535])),
        tc.RunContainer(u16(starts), u16(lengths)),
        tc.ArrayContainer(u16(np.sort(rng.choice(65536, 4096, replace=False)))),
        tc.ArrayContainer(u16([0, 31, 32, 65503, 65535])),
        tc.BitmapContainer(w),
        tc.BitmapContainer(np.full(1024, np.uint64(0xFFFFFFFFFFFFFFFF))),
    ]


def phase_expand_kernel(card: str, base, bitmaps):
    """``rb_expand_rows`` against ``expand_rows_plain`` on the census
    working set's payload (308,100 rows, in the main path's row order) and
    on the edge cases plus run-optimized census containers: one launch per
    call, bitwise equal rows. The payload is staged in pinned host memory
    and shipped once; the kernel is timed on it with CUDA events beside its
    bound (every row written once, the payload read once) and the plain
    version's time; the copy is timed beside the host link's bound."""
    from roaringbitmap_tpu_torch import RoaringBitmap
    from roaringbitmap_tpu_torch.ops import kernels as K
    from roaringbitmap_tpu_torch.parallel import store

    packed = store.pack_groups(store.group_by_key(bitmaps), "cuda")
    payload = packed._payload
    n = payload.n_rows
    if n != ROWS_MAIN:
        fail(f"the census payload has {n} rows, expected {ROWS_MAIN}")
    t0 = time.perf_counter()
    staged = payload.materialize(pinned=True)
    t_stage = time.perf_counter() - t0
    parts = K.payload_parts(n, *staged)
    in_bytes = sum(t.numel() * t.element_size() for t in parts)
    pinned = all(t.is_pinned() for t in parts if t.numel())  # an empty part holds no memory

    def copy_ms(host_parts):
        """Wall of one ship of ``host_parts`` to the card (synchronised),
        the first and the median of three more."""
        walls = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = K.ship_payload(host_parts, "cuda")
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            del out
        return walls[0], float(np.median(walls[1:]))

    copy_first, copy_ms_pinned = copy_ms(parts)
    pageable = K.payload_parts(n, *payload.materialize())
    _first, copy_ms_pageable = copy_ms(pageable)
    del pageable
    shipped = K.ship_payload(parts, "cuda")
    before = K.LAUNCHES["rb_expand_rows"]
    got = K.expand_shipped(n, shipped)
    torch.cuda.synchronize()
    if K.LAUNCHES["rb_expand_rows"] != before + 1:
        fail(f"rb_expand_rows: launches went {before} -> {K.LAUNCHES['rb_expand_rows']}")
    want = K.expand_rows_plain(n, *shipped, "cuda")
    err = _compare("rb_expand_rows census payload", got, want)
    bits_set = int(K.popcount_rows(want).long().sum())
    del got, want
    ms = cuda_ms(lambda: K.expand_shipped(n, shipped))
    plain = cuda_ms(lambda: K.expand_rows_plain(n, *shipped, "cuda"), reps=3, warmup=1)
    nbytes = in_bytes + n * ROW_BYTES
    b = bound_ms(nbytes)
    kinds = {"array": len(payload.arr_rows), "bitmap": len(payload.bmp_rows), "run": len(payload.run_rows)}
    say(
        f"[kernel] rb_expand_rows census payload ({n} rows {kinds}, {payload.n_values} array values, "
        f"{payload.n_run_intervals} runs; {in_bytes} payload bytes): equal ({bits_set} bits); "
        f"{ms:.4f} ms, bound {b:.4f} ms ({nbytes} bytes: the payload read once, every row written "
        f"once; {b / ms:.1%} of bound), plain {plain:.3f} ms; library call: none; pinned staging "
        f"(concatenate) {t_stage * 1e3:.1f} ms; copy to the card from pinned staging (all pinned: "
        f"{pinned}) first {copy_first:.3f} ms, then median {copy_ms_pinned:.3f} ms "
        f"({in_bytes / copy_ms_pinned / 1e6:.2f} GB/s), from pageable numpy {copy_ms_pageable:.3f} ms "
        f"(host link bound {in_bytes / PCIE_BYTES_PER_S * 1e3:.4f} ms)  [{card}]"
    )
    del shipped, staged, parts, packed
    torch.cuda.empty_cache()

    cs = _edge_payload_containers()
    for vals in base[:40]:
        b2 = RoaringBitmap(vals)
        b2.run_optimize()
        cs.extend(b2.high_low_container.containers)
    edge = store.RowPayload.from_containers(cs)
    before = K.LAUNCHES["rb_expand_rows"]
    got = edge.expand_device("cuda")  # the pinned staging path
    torch.cuda.synchronize()
    if K.LAUNCHES["rb_expand_rows"] != before + 1:
        fail("rb_expand_rows: the edge payload did not take one launch")
    want = K.expand_rows_plain(edge.n_rows, *edge.materialize(), "cuda")
    err = max(err, _compare("rb_expand_rows edge cases", got, want))
    if not np.array_equal(got.cpu().numpy().view(np.uint32), edge.expand_host()):
        fail("rb_expand_rows edge cases differ from the host expansion")
    say(f"[kernel] rb_expand_rows edge cases + run-optimized census ({edge.n_rows} rows: "
        f"{len(edge.arr_rows)} array, {len(edge.bmp_rows)} bitmap, {len(edge.run_rows)} run; "
        f"adjacent runs, a run ending at 65535, the full run, 2,047 runs, a 4,096-value array): "
        f"equal to the plain version and the host expansion  [{card}]")
    return {"rb_expand_rows": dict(
        replaces="roaringbitmap_tpu/ops/pallas_kernels.py:expand_rows_device", max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=b, bound_by="bytes",
    )}


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


def _check(name, bm, oracle, tag="[main]"):
    got = bm.to_array()
    if got.shape != oracle.shape or not np.array_equal(got, oracle):
        fail(f"{name}: result ({got.size} values) differs from the numpy oracle ({oracle.size})")
    say(f"{tag} {name}: {got.size} values, equal to the numpy oracle")


def _layout_delta(store, before):
    return {k: v - before[k] for k, v in store.LAYOUT_COUNTS.items() if v != before[k]}


def phase_main(rng, base, bitmaps, real, build_s):
    from roaringbitmap_tpu_torch import FastAggregation, ParallelAggregation, RoaringBitmap
    from roaringbitmap_tpu_torch.ops import kernels as K
    from roaringbitmap_tpu_torch.parallel import store

    n_cont = sum(b.get_container_count() for b in bitmaps)
    say(
        f"[main] {len(bitmaps)} bitmaps ({'census1881' if real else 'synthetic census1881-like'}), "
        f"{n_cont} containers, built in {build_s:.1f} s"
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

    store.PACK_CACHE.close()
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
    agg = store.PACK_CACHE.stats()["kinds"]["agg"]
    say(f"[main] launches over the wide-set OR and XOR runs: {wide}; pack cache {agg}")
    # the OR packs its set (a miss: the cold row-map run), ParallelAggregation
    # and the cardinality hit the resident pack (the padded block, built on
    # the second touch), and the XOR's 9,999 bitmaps are a new working set
    if agg != {"hits": 2, "misses": 2}:
        fail(f"the pack cache served the wide set {agg}, expected 2 hits and 2 misses")
    if (wide["rb_group_reduce[rowmap]"], wide["rb_group_reduce[dense]"]) != (2, 2) or wide["rb_popcount_rows"] < 4:
        fail("the wide-set runs did not go through rb_group_reduce and rb_popcount_rows as expected")

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
    for k in AGGREGATION_KERNELS:
        if launches[k] == 0:
            fail(f"kernel {k} was not launched on the main path")
    return launches


# ---------------------------------------------------------------------------
# phase 5: timing
# ---------------------------------------------------------------------------


def _profiled(tag: str, label: str, fn, card: str, calls: int = 1) -> None:
    """``calls`` back-to-back calls of ``fn`` in a ``tracing.trace`` window
    (``torch.profiler``, its Chrome trace written to a temporary
    directory): wall time, device busy and idle share, and the largest
    device-side entries (all per call). Where the profiler shows no device
    events, the kernels are timed with CUDA events instead
    (:func:`_event_busy`) and the line says so."""
    import tempfile

    from torch.autograd import DeviceType

    from roaringbitmap_tpu_torch import tracing

    # a short profiling session sometimes returns no device events at all;
    # the calls are then profiled once more and the line says so
    for session in (1, 2):
        with tempfile.TemporaryDirectory(prefix="rb_trace_") as logdir:
            with tracing.trace(logdir) as prof:
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) / calls
        # device-side events only (kernels, copies): a CPU op's own entry
        # repeats the device time of the kernels it launched
        by_name = sorted(
            ((e.self_device_time_total, e.key) for e in prof.key_averages()
             if e.device_type != DeviceType.CPU and e.self_device_time_total > 0),
            reverse=True,
        )
        by_name = [(t / calls, k) for t, k in by_name]
        dev_us = sum(t for t, _ in by_name)
        if dev_us:
            break
        say(f"{tag} profiled {label}: session {session} showed no device events")
    if dev_us:
        top = "; ".join(f"{k[:60]} {t / 1e3:.3f} ms" for t, k in by_name[:6])
        say(
            f"{tag} profiled {label} ({calls} call(s), per call): wall {wall * 1e3:.1f} ms, device busy "
            f"{dev_us / 1e3:.3f} ms ({dev_us / 1e6 / wall:.2%}), idle share "
            f"{1 - dev_us / 1e6 / wall:.2%}; top: {top}  [{card}]"
        )
        return
    wall, busy_ms, by = _event_busy(fn, calls)
    top = "; ".join(f"{k} {v:.3f} ms" for k, v in sorted(by.items(), key=lambda kv: -kv[1]))
    say(
        f"{tag} profiled {label}: the profiler showed no device events; CUDA events around each "
        f"kernel wrapper instead ({calls} call(s), per call; kernels only, copies not counted): wall "
        f"{wall * 1e3:.1f} ms, kernels busy {busy_ms:.3f} ms ({busy_ms / 1e3 / wall:.2%}), idle share "
        f"{1 - busy_ms / 1e3 / wall:.2%}; {top}  [{card}]"
    )


# the kernel wrappers of ops/kernels.py that the device paths call through
# the module (looked up at call time), timed one by one by _event_busy
_EVENT_TIMED = (
    "group_reduce", "popcount_rows", "expand_shipped", "threshold_rows", "oneil_compare",
    "pair_rows_reduce", "pair_rows_cardinality", "pairwise_and_card",
)


def _event_busy(fn, calls: int):
    """``calls`` calls of ``fn`` with a CUDA event pair recorded on the
    current stream around every kernel wrapper call: (wall s per call,
    kernels' device ms per call, {wrapper: ms per call}). A pair also
    spans the stream's wait for the launch, so this reads a little high."""
    from roaringbitmap_tpu_torch.ops import kernels as K

    marks = []
    saved = {name: getattr(K, name) for name in _EVENT_TIMED}

    def timed(name, f):
        def run(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = f(*args, **kwargs)
            end.record()
            marks.append((name, start, end))
            return out
        return run

    for name, f in saved.items():
        setattr(K, name, timed(name, f))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / calls
    finally:
        for name, f in saved.items():
            setattr(K, name, f)
    by = {}
    for name, start, end in marks:
        by[name] = by.get(name, 0.0) + start.elapsed_time(end) / calls
    return wall, sum(by.values()), by


def phase_timing(bitmaps, card: str):
    from roaringbitmap_tpu_torch import FastAggregation
    from roaringbitmap_tpu_torch.ops import kernels as K
    from roaringbitmap_tpu_torch.parallel import store

    store.PACK_CACHE.close()
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    groups = store.group_by_key(bitmaps)
    t_groups = time.perf_counter()
    packed = store.pack_groups(groups, "cuda")
    t_payload = time.perf_counter()
    staged = packed._payload.materialize(pinned=True)
    t_concat = time.perf_counter()
    t_pack = t_concat - t_start
    t0 = time.perf_counter()
    shipped = K.ship_payload(K.payload_parts(packed.n_rows, *staged), "cuda")
    torch.cuda.synchronize()
    t_copy = time.perf_counter() - t0
    t0 = time.perf_counter()
    K.expand_shipped(packed.n_rows, shipped)
    torch.cuda.synchronize()
    t_kernel = time.perf_counter() - t0
    t_expand = t_copy + t_kernel
    del staged, shipped
    flat = packed.device_words  # the same expansion, through the pack
    torch.cuda.synchronize()
    say(
        f"[time] pack {t_pack * 1e3:.1f} ms (group_by_key {(t_groups - t_start) * 1e3:.1f}, "
        f"payload {(t_payload - t_groups) * 1e3:.1f}, concatenate into pinned staging "
        f"{(t_concat - t_payload) * 1e3:.1f}); expansion {t_expand * 1e3:.1f} ms (check + copy "
        f"{t_copy * 1e3:.1f}, rb_expand_rows {t_kernel * 1e3:.1f}, synchronised) "
        f"for {packed.n_rows} rows, {packed._payload.nbytes} payload bytes; bound "
        f"{max(bound_ms(packed.n_rows * ROW_BYTES), packed._payload.nbytes / PCIE_BYTES_PER_S * 1e3):.4f} ms "
        f"(rows written on the card {bound_ms(packed.n_rows * ROW_BYTES):.4f} ms, payload over "
        f"the host link {packed._payload.nbytes / PCIE_BYTES_PER_S * 1e3:.4f} ms)  [{card}]"
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

    def cold_or():
        store.PACK_CACHE.close()
        return FastAggregation.or_(*bitmaps)

    _profiled("[time]", "FastAggregation.or_ cold", cold_or, card)
    FastAggregation.or_(*bitmaps)  # resident, padded block built
    _profiled("[time]", "FastAggregation.or_ warm", lambda: FastAggregation.or_(*bitmaps), card)

    torch.cuda.reset_peak_memory_stats()
    for label, prep in (("cold (pack cache closed before each run)", store.PACK_CACHE.close),
                        ("warm (resident pack)", None)):
        if prep is None:
            FastAggregation.or_(*bitmaps)
        walls = []
        for _ in range(E2E_RUNS):
            if prep is not None:
                prep()
            t0 = time.perf_counter()
            FastAggregation.or_(*bitmaps)  # returns a host bitmap: the work is done
            walls.append(time.perf_counter() - t0)
        med = float(np.median(walls))
        say(
            f"[time] FastAggregation.or_ end to end {label} ({len(bitmaps)} bitmaps, to the "
            f"result bitmap), {len(walls)} runs: median {med * 1e3:.2f} ms (min "
            f"{min(walls) * 1e3:.2f}, max {max(walls) * 1e3:.2f}), {1 / med:.3f} aggregations/s  [{card}]"
        )
    peak = torch.cuda.max_memory_allocated()
    st = store.PACK_CACHE.stats()
    say(
        f"[time] peak device memory {peak / 2**30:.2f} GiB ({peak} bytes); pack cache resident "
        f"{st['bytes']} bytes in {st['entries']} entries, budget {st['max_bytes']} bytes  [{card}]"
    )
    store.PACK_CACHE.close()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 8: the query path
# ---------------------------------------------------------------------------

# base-index ranges of Q1's three sets (the stand-in has 200 base bitmaps,
# each cycled 50 times; thirds by position would all hold every base)
Q1_THIRDS = ((0, 67), (67, 134), (134, 200))
Q1_HEAD = 8
Q1_SIZES = (201_098, 3_929, 203_830)  # (A&B)\C, threshold_2(head), Q1 on the stand-in
Q2_SIZES = {64: 1_004_893, 200: 174_452}
OR_SIZE = 1_635_067


def _step_pack_counts(plan, touched=None):
    """(steps over leaves, steps over other steps' results) among the
    plan's device steps, counting only steps whose subtree holds a leaf of
    ``touched`` (a set of leaf uids) when given."""
    over_leaves = over_results = 0
    for st in plan.steps:
        if "device" not in st.engine:
            continue
        if touched is not None and not touched & {l.uid for l in st.node.leaves}:
            continue
        if all(o.op == "leaf" for o in st.operands):
            over_leaves += 1
        else:
            over_results += 1
    return over_leaves, over_results


def _cache_delta(store, before):
    after = store.PACK_CACHE.stats()
    return {k: after[k] - before[k] for k in ("hits", "misses", "delta_rows")}


def _q1_setup(base, bitmaps, real):
    """Q1 over the census working set: the expression, its numpy oracle,
    the sets (A, B, C, head) it reads, and the oracle's parts (the unions
    of A, B and C, (A&B)\\C, threshold_2(head))."""
    from roaringbitmap_tpu_torch import query as tq

    nb = len(base)
    A, B, C = ([b for i, b in enumerate(bitmaps) if lo <= i % nb < hi] for lo, hi in Q1_THIRDS)
    head = bitmaps[:Q1_HEAD]
    uA, uB, uC = (np.unique(np.concatenate(base[lo:hi])) for lo, hi in Q1_THIRDS)
    abc = np.setdiff1d(np.intersect1d(uA, uB), uC)
    v, c = np.unique(np.concatenate([base[i % nb] for i in range(Q1_HEAD)]), return_counts=True)
    t2 = v[c >= 2]
    want_q1 = np.union1d(abc, t2)
    sizes = (abc.size, t2.size, want_q1.size)
    say(f"[query] A, B, C: {len(A)}, {len(B)}, {len(C)} bitmaps; oracle (A&B)\\C {sizes[0]}, "
        f"threshold_2(head) {sizes[1]}, Q1 {sizes[2]} values")
    if not real and sizes != Q1_SIZES:
        fail(f"the stand-in's Q1 oracle sizes are {sizes}, expected {Q1_SIZES}")
    Q = tq.Q
    q1 = ((Q.or_(*A) & Q.or_(*B)) - Q.or_(*C)) | Q.threshold(2, *head)
    return q1, want_q1, (A, B, C, head), (uA, uB, uC, abc, t2)


def phase_query(base, bitmaps, real, card: str):
    """Q1-Q3 through ``query.execute`` and the n-way andnot on the card
    (``aggregation.config.device`` as shipped), every answer against a
    numpy oracle over the base bitmaps and their copy counts."""
    from roaringbitmap_tpu_torch import query as tq
    from roaringbitmap_tpu_torch.ops import kernels as K
    from roaringbitmap_tpu_torch.parallel import aggregation, store

    if (aggregation.config.device, aggregation.config.mode) != ("cuda", "auto"):
        fail(f"aggregation config is {aggregation.config.device}/{aggregation.config.mode}, expected cuda/auto")
    t_phase = time.perf_counter()
    q1, want_q1, (A, B, C, head), (uA, uB, uC, abc, t2) = _q1_setup(base, bitmaps, real)
    nb = len(base)
    Q = tq.Q
    plan = tq.plan(q1)
    lines = plan.explain().splitlines()
    # the step lines without the leaf lines, each operand list cut to its
    # first 6 labels (or(A) alone names 3,350 leaves)
    steps = []
    for ln in lines:
        if " leaf card=" in ln:
            continue
        m = re.match(r"(\s*\S+ \S+?\()(.*?)(\) engine=.*)", ln)
        if m and m.group(2).count(",") > 6:
            ops = m.group(2).split(", ")
            ln = f"{m.group(1)}{', '.join(ops[:6])}, ... {len(ops)} operands{m.group(3)}"
        steps.append(ln)
    say(f"[query] plan(Q1).explain(), {len(lines) - len(steps)} leaf lines left out:\n"
        + "\n".join(f"[query]   {ln}" for ln in steps))
    engines = {st.engine for st in plan.steps}
    need = {"device-or", "andnot-batch[device]", "threshold-bitsliced[device]"}
    if not need <= engines:
        fail(f"Q1's plan has engines {sorted(engines)}, missing {sorted(need - engines)}")
    n_thr = sum(st.engine == "threshold-bitsliced[device]" for st in plan.steps)
    over_leaves, over_results = _step_pack_counts(plan)

    # launches of the query path's runs, summed over the queries (each one
    # zeroes the counts just before it and reads them just after)
    path_launches = dict.fromkeys(K.LAUNCHES, 0)

    def run(q, cache=None):
        K.reset_launches()
        r = tq.execute(q, cache=cache)
        for name, n in K.LAUNCHES.items():
            path_launches[name] += n
        return r

    def run_q1(label, cache, want, expect_thr, expect=None):
        before = store.PACK_CACHE.stats()
        t0 = time.perf_counter()
        r = run(q1, cache)
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in K.LAUNCHES.items() if v}
        delta = _cache_delta(store, before)
        _check_values(f"Q1 {label}", r, want, "[query]")
        say(f"[query] Q1 {label}: {wall * 1e3:.1f} ms; launches {launches}; pack cache {delta}  [{card}]")
        if K.LAUNCHES["rb_threshold"] != expect_thr:
            fail(f"Q1 {label}: {K.LAUNCHES['rb_threshold']} rb_threshold launches, expected {expect_thr}")
        if expect is not None and delta != expect:
            fail(f"Q1 {label}: pack cache {delta}, expected {expect}")
        return wall

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    store.PACK_CACHE.close()
    cold = run_q1("cold (pack cache closed)", None, want_q1, n_thr,
                  {"hits": 0, "misses": over_leaves + over_results, "delta_rows": 0})
    # warm, result cache off: every step over leaves hits its resident pack
    # (zero host packs); a step over other steps' results packs its new
    # operands afresh
    warm = run_q1("warm, result cache off", None, want_q1, n_thr,
                  {"hits": over_leaves, "misses": over_results, "delta_rows": 0})
    say(f"[query] Q1 warm with the result cache off: {over_leaves} steps over leaves served "
        f"resident (zero host packs), {over_results} steps over intermediate results packed anew")
    # one instrumented pass, cold then warm: each step run alone, synchronised
    from roaringbitmap_tpu_torch.query import exec as qexec

    for label in ("cold", "warm"):
        if label == "cold":
            store.PACK_CACHE.close()
        results = {lf.uid: lf.bitmap for lf in plan.root.leaves}
        walls = []
        for st in plan.steps:
            t0 = time.perf_counter()
            results[st.node.uid] = qexec._run_step(st, [results[o.uid] for o in st.operands])
            torch.cuda.synchronize()
            walls.append(f"{st.node.op} {st.engine} {(time.perf_counter() - t0) * 1e3:.1f}")
        say(f"[query] Q1 {label}, result cache off, step by step (ms): {'; '.join(walls)}  [{card}]")
    del results
    _profiled("[query]", "Q1 warm, result cache off", lambda: tq.execute(q1, cache=None), card)
    rc = tq.ResultCache()
    tq.execute(q1, cache=rc)
    warm_rc = run_q1("warm, result cache on", rc, want_q1, 0,
                     {"hits": 0, "misses": 0, "delta_rows": 0})

    # one value into an existing chunk of the last copy of a base of A whose
    # cardinality, plus one, ties no other base's: the planner's cost order
    # (cardinality, then position) keeps the pack's operand order, so the
    # resident pack of A takes the delta route
    cards = np.array([base[b].size for b in range(*Q1_THIRDS[0])])
    pick = next(b for b in range(*Q1_THIRDS[0])
                if not np.isin([cards[b], cards[b] + 1], np.delete(cards, b)).any())
    pos = max(i for i in range(len(bitmaps)) if i % nb == pick)
    keys_b = np.unique(base[pick] >> 16)
    cand = np.setdiff1d(np.setdiff1d(uB, uA), uC)
    cand = cand[np.isin(cand >> 16, keys_b)]
    if cand.size:
        val = int(cand[0])
    else:
        key = int(keys_b[0])
        val = int(np.setdiff1d(np.arange(key << 16, (key + 1) << 16), base[pick])[0])
    bitmaps[pos].add(val)
    uA2 = np.union1d(uA, [val]).astype(np.uint32)
    want_mut = np.union1d(np.setdiff1d(np.intersect1d(uA2, uB), uC), t2)
    leaf_uid = tq.Q.leaf(bitmaps[pos]).uid
    touched = _step_pack_counts(tq.plan(q1), {leaf_uid})
    mutated = run_q1(f"after adding {val} to bitmap {pos} (base {pick}, in A)", rc, want_mut, 0,
                     {"hits": touched[0], "misses": touched[1], "delta_rows": 1})
    say(f"[query] Q1 after the mutation: the pack of A took the delta route (1 row re-expanded "
        f"and written with index_copy_, no full repack); {touched[1]} steps over results re-ran")
    # the delta's scatter alone: one row written into A's resident flat rows
    a_entry = next(e for e in store.PACK_CACHE._entries.values()
                   if e.kind == "agg" and len(e.fps) == len(A))
    flat = a_entry.value.device_words
    one = torch.tensor([a_entry.row_map[(0, int(A[0].high_low_container.keys[0]))]], device="cuda")
    scatter = cuda_ms(lambda: flat.index_copy_(0, one, flat.index_select(0, one)))
    say(f"[query] index_copy_ of one row into A's resident [{flat.shape[0]}, 2048] rows: "
        f"{scatter:.4f} ms (bound {bound_ms(2 * ROW_BYTES):.6f} ms)  [{card}]")
    del flat
    bitmaps[pos].remove(val)  # restore the working set for the queries below

    # Q2: threshold(k) over all 10,000 bitmaps
    mult = np.bincount(np.arange(len(bitmaps)) % nb, minlength=nb)
    allv = np.concatenate(base)
    uniq, inv = np.unique(allv, return_inverse=True)
    counts = np.bincount(inv, weights=np.repeat(mult, [b.size for b in base]))
    if uniq.size != OR_SIZE and not real:
        fail(f"the stand-in's OR has {uniq.size} values, expected {OR_SIZE}")
    q2_walls = {}
    for k in THRESHOLD_KS:
        want = uniq[counts >= k].astype(np.uint32)
        if want.size in (0, uniq.size) or (not real and want.size != Q2_SIZES[k]):
            fail(f"Q2 k={k}: the oracle has {want.size} values")
        q = Q.threshold(k, *bitmaps)
        for label in ("cold (pack, expansion, padded block)", "warm (resident pack)"):
            before = store.PACK_CACHE.stats()
            t0 = time.perf_counter()
            r = run(q)
            wall = time.perf_counter() - t0
            q2_walls.setdefault(k, wall)
            _check_values(f"Q2 threshold({k}, all {len(bitmaps)}) {label}", r, want, "[query]")
            if K.LAUNCHES["rb_threshold"] != 1:
                fail(f"Q2 k={k}: {K.LAUNCHES['rb_threshold']} rb_threshold launches, expected 1")
            say(f"[query] Q2 k={k} {label}: {wall * 1e3:.1f} ms, one rb_threshold launch; pack "
                f"cache {_cache_delta(store, before)}  [{card}]")

    # Q3: the n-way andnot's count-only form
    first = tq.execute(Q.or_(*A) & Q.or_(*B), cache=None)
    K.reset_launches()
    t0 = time.perf_counter()
    got = tq.andnot_nway_cardinality(first, *C)
    t_q3 = time.perf_counter() - t0
    for name, n in K.LAUNCHES.items():
        path_launches[name] += n
    if got != abc.size:
        fail(f"Q3 andnot_nway_cardinality = {got}, oracle {abc.size}")
    if not K.LAUNCHES["rb_popcount_rows"] or not sum(v for k, v in K.LAUNCHES.items() if k.startswith("rb_group_reduce")):
        fail(f"Q3 did not run on the device: {K.LAUNCHES}")
    say(f"[query] Q3 andnot_nway_cardinality(or(A) & or(B), *C) = {got}, equal to the oracle; "
        f"{t_q3 * 1e3:.1f} ms; launches {dict((k, v) for k, v in K.LAUNCHES.items() if v)}  [{card}]")
    # the andnot mask (torch ops) and its popcount on Q3's rows
    from roaringbitmap_tpu_torch.query import kernels as qk

    ckeys, _ = qk._covered(first, C)
    first_rows, union, _, _ = qk._device_andnot_stage(first, C, ckeys)
    mask_ms = cuda_ms(lambda: K.popcount_rows(first_rows & ~union))
    say(f"[query] the andnot mask first & ~union + rb_popcount_rows on [{first_rows.shape[0]}, 2048]: "
        f"{mask_ms:.4f} ms (bound {bound_ms(3 * first_rows.numel() * 4):.6f} ms)  [{card}]")
    del first_rows, union

    peak = torch.cuda.max_memory_allocated()
    st = store.PACK_CACHE.stats()
    say(
        f"[query] Q1 cold {cold * 1e3:.1f} ms, warm (result cache off) {warm * 1e3:.1f} ms, warm "
        f"(result cache on) {warm_rc * 1e3:.2f} ms, after a mutation {mutated * 1e3:.1f} ms; Q2 "
        f"{', '.join(f'k={k} {w * 1e3:.1f} ms' for k, w in q2_walls.items())}; peak device memory "
        f"{peak / 2**30:.2f} GiB ({peak} bytes); pack cache resident {st['bytes']} bytes in "
        f"{st['entries']} entries (budget {st['max_bytes']}); phase {time.perf_counter() - t_phase:.1f} s  [{card}]"
    )
    store.PACK_CACHE.close()
    torch.cuda.empty_cache()
    say(f"[query] launches over the query path: {path_launches}")
    if not path_launches["rb_threshold"]:
        fail("rb_threshold was not launched on the query path")
    return path_launches


# ---------------------------------------------------------------------------
# phase 9: the columnar pairwise engine
# ---------------------------------------------------------------------------

FACADE = {"and": "and_", "or": "or_", "xor": "xor", "andnot": "andnot"}
SET_OPS = {"and": np.intersect1d, "or": np.union1d, "xor": np.setxor1d, "andnot": np.setdiff1d}
# the window's stages, each the wall of the module functions named, summed
# over one pairwise_multi call (the device ones synchronised)
WINDOW_STAGES = ("rows", "key plan + classify", "host buckets", "kernel", "copy to host",
                 "container build", "assembly")


class _StageClock:
    """Wraps the module functions ``pairwise_multi`` reaches so that one
    call reports the wall of each stage: ``rows`` (resident-row lookups and
    the concatenation of each side's blocks), ``key plan + classify``,
    ``host buckets`` (the classes the host serves), ``kernel``
    (``rb_pair_rows``, synchronised), ``copy to host`` (the result words),
    ``container build`` and ``assembly``. The call itself is the port's."""

    def __init__(self):
        from roaringbitmap_tpu_torch.columnar import device as cdev
        from roaringbitmap_tpu_torch.columnar import engine as E
        from roaringbitmap_tpu_torch.ops import device as dev
        from roaringbitmap_tpu_torch.ops import kernels as K

        self.t = dict.fromkeys(WINDOW_STAGES, 0.0)
        self._open = dict.fromkeys(WINDOW_STAGES, 0)  # a stage's calls in progress
        self.kernel_ms = 0.0
        self._patches = [
            (cdev, "rows_for", "rows", False), (K, "concat_rows", "rows", True),
            (E, "key_plan", "key plan + classify", False),
            (cdev, "classify", "key plan + classify", False),
            (E, "_fill_nonbm", "host buckets", False), (E, "_fill_aa", "host buckets", False),
            (K, "pair_rows_reduce", "kernel", True),
            (dev, "to_host_u32", "copy to host", False),
            (E, "_format_rows_results", "container build", False),
            (E, "_assemble_pairwise", "assembly", False),
        ]
        self._saved = []

    def _wrap(self, fn, stage, sync):
        def timed(*args, **kw):
            if self._open[stage]:  # nested in the same stage (_fill_nonbm -> _fill_aa): counted once
                return fn(*args, **kw)
            self._open[stage] += 1
            try:
                return run(*args, **kw)
            finally:
                self._open[stage] -= 1

        def run(*args, **kw):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            if stage == "kernel":
                ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                ev0.record()
                out = fn(*args, **kw)
                ev1.record()
                torch.cuda.synchronize()
                self.kernel_ms += ev0.elapsed_time(ev1)
            else:
                out = fn(*args, **kw)
                if sync:
                    torch.cuda.synchronize()
            self.t[stage] += time.perf_counter() - t0
            return out

        return timed

    def __enter__(self):
        for mod, name, stage, sync in self._patches:
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))
            setattr(mod, name, self._wrap(fn, stage, sync))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved = []


def _percontainer(op, x, y):
    from roaringbitmap_tpu_torch import RoaringBitmap, columnar

    with columnar.disabled():
        return getattr(RoaringBitmap, FACADE[op])(x, y)


def _pairs_ns(fns, pairs, runs: int = FACADE_RUNS, detail: dict = None) -> dict:
    """The ns per pair of each of ``fns`` (name -> function) over the
    pairs: every call timed alone, each pair's median over ``runs`` runs,
    the mean over the pairs. The functions take turns within each run, so
    that a drift of the host's speed reaches all alike, and a stall of the
    host (another process, a garbage collection) lands in one run of a
    pair and not in its median (each call returns a host bitmap: its work
    is done). ``detail``, when given, receives each function's run walls
    (ms) and the garbage collections by generation that ran inside its
    timed loops."""
    calls = {name: np.empty((runs, len(pairs))) for name in fns}
    gcs = {name: [0, 0, 0] for name in fns}
    for r in range(runs):
        for name, fn in fns.items():
            row = calls[name][r]
            before = [g["collections"] for g in gc.get_stats()]
            for i, (x, y) in enumerate(pairs):
                t0 = time.perf_counter()
                fn(x, y)
                row[i] = time.perf_counter() - t0
            for i, g in enumerate(gc.get_stats()):
                gcs[name][i] += g["collections"] - before[i]
    if detail is not None:
        for name, t in calls.items():
            detail[name] = {"walls_ms": [round(float(w) * 1e3, 1) for w in t.sum(axis=1)], "gc": gcs[name]}
    return {name: float(np.median(t, axis=0).mean()) * 1e9 for name, t in calls.items()}


def _unpack_race(E, pairs, card: str) -> None:
    """One more or window, its array results taken out of their words both
    ways on the same words before the engine formats them: one extension
    call a row (``bits.values_from_words``, the native tier's way and the
    engine's there) and ``kernels.values_rows`` in its blocks (the numpy
    tier's); the two must give the same values."""
    from roaringbitmap_tpu_torch import columnar
    from roaringbitmap_tpu_torch.columnar import kernels as ck
    from roaringbitmap_tpu_torch.utils import bits

    real = E._format_rows_results
    t = {"rows": 0, "values": 0, "per-row extension": 0.0, "values_rows": 0.0}

    def fmt(words64, cards, idx, results):
        c = np.asarray(cards, dtype=np.int64)
        small = np.flatnonzero((c > 0) & (c <= 4096))
        t0 = time.perf_counter()
        rows = [bits.values_from_words(words64[j]) for j in small.tolist()]
        t1 = time.perf_counter()
        blocks = [ck.values_rows(words64[small[lo:lo + E._VALUES_BLOCK]])[0]
                  for lo in range(0, small.size, E._VALUES_BLOCK)]
        t2 = time.perf_counter()
        if rows and not np.array_equal(np.concatenate(rows), np.concatenate(blocks)):
            fail("the or window's values: per-row extension calls and values_rows differ")
        t["rows"] += small.size
        t["values"] += sum(r.size for r in rows)
        t["per-row extension"] += t1 - t0
        t["values_rows"] += t2 - t1
        return real(words64, cards, idx, results)

    E._format_rows_results = fmt
    try:
        columnar.pairwise_multi("or", pairs, tier="device")
    finally:
        E._format_rows_results = real
    say(f"[columnar] or window's array results out of their words ({t['rows']} rows, {t['values']} values): "
        f"one extension call a row {t['per-row extension'] * 1e3:.1f} ms, kernels.values_rows in blocks of "
        f"{E._VALUES_BLOCK} {t['values_rows'] * 1e3:.1f} ms, the same values  [{card}]")


def phase_columnar(base, bitmaps, card: str, n_pairs: int = WINDOW_PAIRS):
    """The columnar pairwise engine on the realdata pairwise benchmark's
    deployment: run-optimized clones of the 10,000 bitmaps, resident as
    ``colrows``, the first ``n_pairs`` of their 9,999 adjacent pairs
    through ``pairwise_multi`` on the device tier; the routed facade on
    the first 199 pairs; bitmap-heavy synthetic pairs; every result
    against numpy or the per-container walk; the routed facade may be at
    most FACADE_LIMIT times as slow as the per-container walk for any op.
    Returns the launch counts of the window (this phase's main path)."""
    from roaringbitmap_tpu_torch import RoaringBitmap, columnar
    from roaringbitmap_tpu_torch.columnar import costmodel
    from roaringbitmap_tpu_torch.columnar import device as cdev
    from roaringbitmap_tpu_torch.columnar import engine as E
    from roaringbitmap_tpu_torch.ops import kernels as K
    from roaringbitmap_tpu_torch.parallel import store

    t_phase = time.perf_counter()
    nb = len(base)
    t0 = time.perf_counter()
    clones = [b.clone() for b in bitmaps]
    for c in clones:
        c.run_optimize()
    kinds = {}
    for c in clones:
        for x in c.high_low_container.containers:
            kinds[type(x).__name__] = kinds.get(type(x).__name__, 0) + 1
    pairs = list(zip(clones[:-1], clones[1:]))[:n_pairs]
    uniq = [np.unique(b).astype(np.uint32) for b in base]
    oracle = {}
    for i in range(len(pairs)):
        k = (i % nb, (i + 1) % nb)
        if k not in oracle:
            oracle[k] = {op: SET_OPS[op](uniq[k[0]], uniq[k[1]]) for op in PAIR_OPS}
    say(f"[columnar] {len(clones)} run-optimized clones ({sum(kinds.values())} containers: {kinds}), "
        f"{len(pairs)} adjacent pairs, numpy oracles for {len(oracle)} distinct base pairs in "
        f"{time.perf_counter() - t0:.1f} s")

    store.PACK_CACHE.close()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    E.reset_counts()
    t0 = time.perf_counter()
    for c in clones:
        cdev.rows_for(c)
    torch.cuda.synchronize()
    t_rows = time.perf_counter() - t0
    colrows = [e for e in store.PACK_CACHE._entries.values() if e.kind == "colrows"]
    n_rows = sum(int(e.value.shape[0]) for e in colrows)
    col_bytes = sum(e.nbytes for e in colrows)
    say(f"[columnar] resident rows: {len(colrows)} colrows entries, {n_rows} rows, {col_bytes} bytes, "
        f"built in {t_rows:.1f} s (ship_rows per bitmap)  [{card}]")

    # 1. the whole window, one pairwise_multi per op; the first of its timed runs
    window = {op: [] for op in PAIR_OPS}
    stages = {op: [] for op in PAIR_OPS}
    kernel_ms = {op: [] for op in PAIR_OPS}

    def window_run(op):
        with _StageClock() as clock:
            t0 = time.perf_counter()
            out = columnar.pairwise_multi(op, pairs, tier="device")
            wall = time.perf_counter() - t0
        window[op].append(wall)
        stages[op].append(dict(clock.t))
        kernel_ms[op].append(clock.kernel_ms)
        return out

    # --- the main path of this phase: the window, with the counts live ---
    K.reset_launches()
    for op in PAIR_OPS:
        before = K.LAUNCHES["rb_pair_rows"]
        out = window_run(op)
        launched = K.LAUNCHES["rb_pair_rows"] - before
        if len(out) != len(pairs):
            fail(f"pairwise_multi {op}: {len(out)} results for {len(pairs)} pairs")
        for i, r in enumerate(out):
            want = oracle[(i % nb, (i + 1) % nb)][op]
            got = r.to_array()
            if got.shape != want.shape or not np.array_equal(got, want):
                fail(f"pairwise_multi {op}: pair {i} has {got.size} values, the numpy oracle {want.size}")
        # a run-optimized census pair holds no bitmap container: and/andnot's
        # dense bucket is empty; or/xor send every pair that is not aa
        expect = 1 if op in ("or", "xor") or kinds.get("BitmapContainer") else 0
        if launched != expect:
            fail(f"pairwise_multi {op}: {launched} rb_pair_rows launches, expected {expect}")
        n_vals = sum(r.get_cardinality() for r in out)
        say(f"[columnar] pairwise_multi {op} over {len(pairs)} pairs: every result equal to numpy's "
            f"{SET_OPS[op].__name__} ({n_vals} values in all); {launched} rb_pair_rows launch(es); "
            f"{window[op][0] * 1e3:.1f} ms  [{card}]")
        del out
    launches = dict(K.LAUNCHES)
    say(f"[columnar] launches over the window (the columnar path): "
        f"{dict((k, v) for k, v in launches.items() if v)}")
    if not launches["rb_pair_rows"]:
        fail("rb_pair_rows was not launched on the columnar path")
    batch = {k: v for k, v in E.BATCH_COUNTS.items()}
    say(f"[columnar] container pairs by op/class over the window: {batch}")
    say(f"[columnar] colrows {col_bytes} bytes resident; peak device memory over the window "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({torch.cuda.max_memory_allocated()} bytes)  [{card}]")

    # 2. the routed facade over jmh's and2by2 set, after ensure_calibrated()
    head = pairs[:FACADE_PAIRS]
    costmodel.MODEL.reset()
    t0 = time.perf_counter()
    model = columnar.ensure_calibrated()
    t_cal = time.perf_counter() - t0
    if not model.calibrated or not model.device_eligible():
        fail(f"ensure_calibrated() on the card left calibrated={model.calibrated}")
    routes0 = dict(E.ROUTE_COUNTS)
    launches0 = K.LAUNCHES["rb_pair_rows"]
    for op in PAIR_OPS:
        fn = getattr(RoaringBitmap, FACADE[op])
        for x, y in head:
            want = _percontainer(op, x, y)
            if fn(x, y) != want:
                fail(f"routed RoaringBitmap.{FACADE[op]} differs from the per-container walk")
            if columnar.pairwise(op, x, y, tier="device") != want:
                fail(f"{op} forced onto the device tier differs from the per-container walk")
    for x, y in head:
        with columnar.disabled():
            card_want, inter_want = RoaringBitmap.and_cardinality(x, y), RoaringBitmap.intersects(x, y)
        if (RoaringBitmap.and_cardinality(x, y), RoaringBitmap.intersects(x, y)) != (card_want, inter_want):
            fail("routed and_cardinality / intersects differ from the per-container walk")
    verdicts = {k: v - routes0[k] for k, v in E.ROUTE_COUNTS.items()}
    est = {op: model.choose(31, 31, "run", False, op=op)[1].get("est_us") for op in ("and", "or")}
    say(f"[columnar] routed facade (and_/or_/xor/andnot, and_cardinality, intersects) and the forced "
        f"device tier over {len(head)} pairs: equal to the per-container walk; ensure_calibrated() "
        f"{t_cal:.2f} s (device cells included); verdicts by tier {verdicts}; the model's estimates "
        f"at 31 x 31 run-shaped containers (us): {est}; rb_pair_rows launches "
        f"{K.LAUNCHES['rb_pair_rows'] - launches0}  [{card}]")

    # 3. bitmap-heavy pairs: real work for and/andnot's dense bucket
    rng = np.random.default_rng(SEED + 7)
    for n in SYNTH_NS:
        t0 = time.perf_counter()
        a, b = costmodel._synthetic_pair("bitmap", n, rng)
        t_build = time.perf_counter() - t0
        for op in PAIR_OPS:
            before = K.LAUNCHES["rb_pair_rows"]
            got = columnar.pairwise(op, a, b, tier="device")
            if K.LAUNCHES["rb_pair_rows"] != before + 1:
                fail(f"bitmap-heavy {op} n={n}: {K.LAUNCHES['rb_pair_rows'] - before} launches, expected 1")
            if got != _percontainer(op, a, b):
                fail(f"bitmap-heavy {op} n={n}: the device tier differs from the per-container walk")
        say(f"[columnar] bitmap-heavy pair, {n} containers a side ({n // 2} bitmaps, "
            f"{a.get_container_count() * ROW_BYTES} bytes of rows an operand, built in {t_build:.1f} s): "
            f"and/or/xor/andnot on the device tier equal to the per-container walk, one rb_pair_rows "
            f"launch each  [{card}]")
        del a, b

    # 4. timings: the window per op (medians with stages), the facade per tier
    for op in PAIR_OPS:
        for _ in range(COLUMNAR_RUNS - 1):
            window_run(op)
        med = float(np.median(window[op]))
        st = {k: float(np.median([s[k] for s in stages[op]])) for k in WINDOW_STAGES}
        other = med - sum(st.values())
        say(f"[columnar] pairwise_multi {op} over {len(pairs)} pairs, {COLUMNAR_RUNS} runs: median "
            f"{med * 1e3:.1f} ms ({min(window[op]) * 1e3:.1f}-{max(window[op]) * 1e3:.1f}), "
            f"{med / len(pairs) * 1e9:.0f} ns per pair; stages (median ms): "
            + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in st.items())
            + f", other {other * 1e3:.1f}; rb_pair_rows by CUDA events "
            f"{float(np.median(kernel_ms[op])):.3f} ms  [{card}]")
    _unpack_race(E, pairs, card)
    tiers = {
        "per-container": lambda op: (lambda x, y: _percontainer(op, x, y)),
        "routed": lambda op: getattr(RoaringBitmap, FACADE[op]),
        "columnar-cpu": lambda op: (lambda x, y: columnar.pairwise(op, x, y, tier="cpu")),
        "columnar-device": lambda op: (lambda x, y: columnar.pairwise(op, x, y, tier="device")),
    }
    slow = []
    for op in PAIR_OPS:
        routes0 = dict(E.ROUTE_COUNTS)
        detail = {}
        ns = _pairs_ns({name: mk(op) for name, mk in tiers.items()}, head, detail=detail)
        verdicts = {k: v - routes0[k] for k, v in E.ROUTE_COUNTS.items() if v != routes0[k]}
        ratio = ns["routed"] / ns["per-container"]
        say(f"[columnar] facade {op} over {len(head)} pairs, ns per pair (each pair's median of "
            f"{FACADE_RUNS} runs, tiers in turn): " + ", ".join(f"{k} {v:.0f}" for k, v in ns.items())
            + f"; routed / per-container {ratio:.3f}; verdicts {verdicts}; walls (ms) and garbage "
            f"collections by generation per tier {detail}  [{card}]")
        if ratio > FACADE_LIMIT:
            slow.append(f"{op} {ratio:.3f}")
    if slow:
        fail(f"the routed facade is slower than the per-container walk by more than "
             f"{FACADE_LIMIT - 1:.0%}: {', '.join(slow)}")
    peak = torch.cuda.max_memory_allocated()
    say(f"[columnar] peak device memory {peak / 2**30:.2f} GiB ({peak} bytes); phase "
        f"{time.perf_counter() - t_phase:.1f} s  [{card}]")
    del clones, pairs, head
    store.PACK_CACHE.close()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 10: serving — the fusion window and the overlap shipping lane
# ---------------------------------------------------------------------------

SERVING_RUNS = 3  # window walls: median of 3, fused and serial in turns


def _union_of(base, idx):
    return np.unique(np.concatenate([base[i] for i in idx]))


def _at_least(base, idx, k):
    v, c = np.unique(np.concatenate([base[i] for i in idx]), return_counts=True)
    return v[c >= k]


class _TierProbe:
    """Wraps the fused executor's merged device tiers for one window:
    records each call's step count and the kernel launches it made, and
    the shapes ``threshold_rows`` was given."""

    def __init__(self, fusion, K):
        self.fusion, self.K = fusion, K
        self.andnot, self.threshold, self.threshold_calls = [], [], []

    def __enter__(self):
        fusion, K = self.fusion, self.K
        self.saved = (fusion._merged_andnot_device, fusion._merged_threshold_device, K.threshold_rows)
        real_andnot, real_thr, real_rows = self.saved

        def andnot(ready, results):
            before = K.LAUNCHES["rb_pair_rows"]
            out = real_andnot(ready, results)
            self.andnot.append((len(ready), K.LAUNCHES["rb_pair_rows"] - before))
            return out

        def thr(ready, results):
            before = K.LAUNCHES["rb_threshold"]
            out = real_thr(ready, results)
            self.threshold.append((len(ready), K.LAUNCHES["rb_threshold"] - before))
            return out

        def rows(words3, k, n_slices):
            self.threshold_calls.append((int(k), int(n_slices), tuple(words3.shape[:2])))
            return real_rows(words3, k, n_slices)

        fusion._merged_andnot_device, fusion._merged_threshold_device = andnot, thr
        K.threshold_rows = rows
        return self

    def __exit__(self, *exc):
        self.fusion._merged_andnot_device, self.fusion._merged_threshold_device, self.K.threshold_rows = self.saved


def _serving_window(base, bitmaps, Q):
    """Phase 10's window of 8 queries over Q1's sets and heads, built with
    the query API ``Q``: ``(window, (A, B, C, C1, C2), AB, ab, uC)`` where
    ``window`` lists (name, query, numpy oracle), Q1 first, and ``AB`` is
    the ``or(A) & or(B)`` node five of them share (``ab`` its oracle)."""
    nb = len(base)
    sel = lambda lo, hi, bms=bitmaps: [b for i, b in enumerate(bms) if lo <= i % nb < hi]  # noqa: E731
    (lo_a, hi_a), (lo_b, hi_b), (lo_c, hi_c) = Q1_THIRDS
    mid_c = (lo_c + hi_c) // 2
    A, B, C = sel(lo_a, hi_a), sel(lo_b, hi_b), sel(lo_c, hi_c)
    C1, C2 = sel(lo_c, mid_c), sel(mid_c, hi_c)
    head, head2, head3 = bitmaps[:8], bitmaps[nb:nb + 8], bitmaps[8:16]  # head2: head's bases again
    uA, uB, uC = (_union_of(base, range(lo, hi)) for lo, hi in Q1_THIRDS)
    uC1, uC2 = _union_of(base, range(lo_c, mid_c)), _union_of(base, range(mid_c, hi_c))
    t2 = _at_least(base, range(8), 2)
    t3_3 = _at_least(base, range(8, 16), 3)
    ab = np.intersect1d(uA, uB)

    # eight single bitmaps with the fewest containers: two-operand steps
    # over them stay under the planner's device gate, so they take the
    # pairwise engine (the columnar router's class)
    xi = sorted(range(16, nb), key=lambda i: (bitmaps[i].get_container_count(), i))[:8]
    x = [bitmaps[i] for i in xi]
    u = [np.unique(base[i % nb]) for i in xi]
    orA, orB, orC, orC1, orC2 = (Q.or_(*s_) for s_ in (A, B, C, C1, C2))
    L = [Q.leaf(b) for b in x]
    AB = orA & orB  # one hash-consed node, shared by five queries
    thr_head, thr_head2 = Q.threshold(2, *head), Q.threshold(2, *head2)
    window = [
        ("Q1", (AB - orC) | thr_head, np.union1d(np.setdiff1d(ab, uC), t2)),
        ("(A&B)-C1 | T2(head')", (AB - orC1) | thr_head2, np.union1d(np.setdiff1d(ab, uC1), t2)),
        ("(A&B)-C2 | T3(head3)", (AB - orC2) | Q.threshold(3, *head3), np.union1d(np.setdiff1d(ab, uC2), t3_3)),
        ("(A&B) | (x0&x1)", AB | (L[0] & L[1]), np.union1d(ab, np.intersect1d(u[0], u[1]))),
        ("(A&B) ^ (x2&x3)", AB ^ (L[2] & L[3]), np.setxor1d(ab, np.intersect1d(u[2], u[3]))),
        ("(x4&x5) | (x6^x7)", (L[4] & L[5]) | (L[6] ^ L[7]),
         np.union1d(np.intersect1d(u[4], u[5]), np.setxor1d(u[6], u[7]))),
        ("B - C1", orB - orC1, np.setdiff1d(uB, uC1)),
        ("T2(head') & A", thr_head2 & orA, np.intersect1d(t2, uA)),
    ]
    return window, (A, B, C, C1, C2), AB, ab, uC


def phase_serving(base, bitmaps, card: str):
    """The serving shape on the census working set at full width: (a) a
    fusion window of 8 queries over Q1's A / B / C sets and heads through
    ``execute_fused`` against serial ``execute`` and numpy; (b)
    ``run_pipelined`` over four wide ORs of disjoint quarters of the 10,000
    bitmaps against the same four run serially; (c) ``execute_pipelined``
    over four Q1-shaped queries, one a quarter, against serial. Returns
    the launch counts of (b), the lane's path."""
    from roaringbitmap_tpu_torch import FastAggregation
    from roaringbitmap_tpu_torch import query as tq
    from roaringbitmap_tpu_torch.ops import kernels as K
    from roaringbitmap_tpu_torch.parallel import overlap, store
    from roaringbitmap_tpu_torch.query import fusion

    t_phase = time.perf_counter()
    nb = len(base)
    if not overlap.LANE.threaded():
        fail(f"the shipping lane is not threaded on this host ({overlap.LANE.threading_mode})")
    Q = tq.Q
    window, (A, B, C, C1, C2), AB, ab, uC = _serving_window(base, bitmaps, Q)
    qs = [q for _n, q, _w in window]
    plans = [tq.plan(q) for q in qs]
    unique = {}
    for p in plans:
        for st in p.steps:
            unique.setdefault(st.node.uid, st)
    classes = {}
    for st in unique.values():
        cls = fusion._merge_class(st)[0]
        classes[cls] = classes.get(cls, 0) + 1
    shared = sum(AB.uid in {st.node.uid for st in p.steps} for p in plans)
    say(f"[serving] fusion window: {len(qs)} queries over A, B, C ({len(A)}, {len(B)}, {len(C)} "
        f"bitmaps; C1, C2 {len(C1)}, {len(C2)}) and three heads of 8; {sum(len(p.steps) for p in plans)} "
        f"plan steps, {len(unique)} unique; unique steps by merge class {classes}; or(A) & or(B) in "
        f"{shared} plans")
    for cls in ("pairwise", "andnot", "threshold-device"):
        if classes.get(cls, 0) < 2:
            fail(f"the window has {classes.get(cls, 0)} {cls} steps, expected at least 2")
    if shared < 3:
        fail(f"or(A) & or(B) is shared by {shared} plans, expected at least 3")

    def check(label, outs):
        for (name, _q, want), r in zip(window, outs):
            got = r.to_array()
            if got.shape != want.shape or not np.array_equal(got, want.astype(np.uint32)):
                fail(f"{label} {name}: {got.size} values, the numpy oracle {want.size}")

    def serial():
        return [tq.execute(q, cache=None) for q in qs]

    def fused():
        return tq.execute_fused(qs, cache=None)

    # --- the window's main path: fused, cold, with the counts live ---
    store.PACK_CACHE.close()
    K.reset_launches()
    fusion.reset_counts()
    with _TierProbe(fusion, K) as probe:
        t0 = time.perf_counter()
        outs = fused()
        wall = time.perf_counter() - t0
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    check("fused", outs)
    ref = serial()
    check("serial", ref)
    for (name, _q, _w), f, r in zip(window, outs, ref):
        if f.serialize() != r.serialize():
            fail(f"fused {name}: the bytes differ from serial execute")
    say(f"[serving] fused window, cold: every result equal to serial execute (bytes) and the numpy "
        f"oracle; {wall * 1e3:.1f} ms; STEP_COUNTS {fusion.STEP_COUNTS}; launches {launches}; merged "
        f"andnot tiers (steps, rb_pair_rows launches) {probe.andnot}; merged threshold tiers (steps, "
        f"rb_threshold launches) {probe.threshold}; threshold_rows calls (k, n_slices, [G, M]) "
        f"{probe.threshold_calls}  [{card}]")
    if not probe.andnot or any(n_launch != 1 for _s, n_launch in probe.andnot) or max(
        s for s, _l in probe.andnot
    ) < 2:
        fail(f"the merged andnot did not run as one rb_pair_rows launch over >= 2 steps: {probe.andnot}")
    buckets = {(k, ns, m) for k, ns, (_g, m) in probe.threshold_calls}
    n_thr_steps = sum(s for s, _l in probe.threshold)
    if len(buckets) != len(probe.threshold_calls) or sum(l for _s, l in probe.threshold) != len(buckets) \
            or len(buckets) >= n_thr_steps:
        fail(f"the equal-bucket thresholds did not run as one rb_threshold launch a bucket: "
             f"{probe.threshold_calls} for {n_thr_steps} steps")
    if fusion.STEP_COUNTS["deduped"] < 4 or fusion.STEP_COUNTS["merged"] < 6:
        fail(f"the window deduped or merged too little: {fusion.STEP_COUNTS}")
    del outs, ref

    walls = {("serial", "cold"): [], ("fused", "cold"): [], ("serial", "warm"): [], ("fused", "warm"): []}
    for state in ("cold", "warm"):
        if state == "warm":
            fused()  # the packs of the steps over leaves resident
        for _ in range(SERVING_RUNS):
            for kind, fn in (("serial", serial), ("fused", fused)):
                if state == "cold":
                    store.PACK_CACHE.close()
                t0 = time.perf_counter()
                fn()
                walls[(kind, state)].append(time.perf_counter() - t0)
    say("[serving] window walls, " + f"{SERVING_RUNS} runs each, fused and serial in turns (result cache off): "
        + "; ".join(f"{kind} {state} median {np.median(w) * 1e3:.1f} ms ({min(w) * 1e3:.1f}-{max(w) * 1e3:.1f})"
                    for (kind, state), w in walls.items()) + f"  [{card}]")
    store.PACK_CACHE.close()
    _profiled("[serving]", "execute_fused window, cold", lambda: (store.PACK_CACHE.close(), fused()), card)

    # (b) run_pipelined over four wide ORs of disjoint quarters
    quarter = len(bitmaps) // 4
    quarters = [bitmaps[i * quarter:(i + 1) * quarter] for i in range(4)]
    jobs = [(q, "or") for q in quarters]
    want_q = [_union_of(base, sorted({i % nb for i in range(j * quarter, (j + 1) * quarter)})) for j in range(4)]

    def check_or(label, outs):
        for j, (r, want) in enumerate(zip(outs, want_q)):
            got = r.to_array()
            if got.shape != want.shape or not np.array_equal(got, want.astype(np.uint32)):
                fail(f"{label} quarter {j}: {got.size} values, the numpy oracle {want.size}")

    def or_serial():
        return [FastAggregation.or_(*q) for q in quarters]

    def or_pipelined():
        return overlap.run_pipelined(jobs)

    # --- the lane's main path: counts zeroed just before, read just after ---
    store.PACK_CACHE.close()
    overlap.LANE.reset_stats()
    torch.cuda.synchronize()
    K.reset_launches()
    outs = or_pipelined()
    lane_launches = dict(K.LAUNCHES)
    stats = overlap.LANE.stats()
    check_or("run_pipelined", outs)
    check_or("serial", or_serial())
    say(f"[serving] run_pipelined over 4 wide ORs of {quarter} bitmaps each (pack cache closed): "
        f"every result equal to serial FastAggregation.or_ and the numpy oracle; launches "
        f"{dict((k, v) for k, v in lane_launches.items() if v)}; lane {stats}")
    if lane_launches["rb_expand_rows"] != 4:
        fail(f"run_pipelined made {lane_launches['rb_expand_rows']} rb_expand_rows launches, expected 4")
    if stats["staged_s"] <= 0:
        fail("the lane staged nothing in run_pipelined")
    pw = {"serial": [], "pipelined": []}
    ratios = []
    for kind in ("serial", "pipelined", "pipelined", "serial"):
        store.PACK_CACHE.close()
        overlap.LANE.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (or_serial if kind == "serial" else or_pipelined)()
        pw[kind].append(time.perf_counter() - t0)
        if kind == "pipelined":
            ratios.append(overlap.LANE.stats()["overlap_ratio"])
    say(f"[serving] 4 wide ORs cold, serial / pipelined in turns (ms): serial "
        f"{', '.join(f'{w * 1e3:.1f}' for w in pw['serial'])}; pipelined "
        f"{', '.join(f'{w * 1e3:.1f}' for w in pw['pipelined'])}; lane overlap ratio (hidden / staged) "
        f"{', '.join(f'{r:.4f}' for r in ratios)}  [{card}]")
    _profiled("[serving]", "run_pipelined 4 wide ORs, cold", lambda: (store.PACK_CACHE.close(), or_pipelined()), card)
    _profiled("[serving]", "4 wide ORs serial, cold", lambda: (store.PACK_CACHE.close(), or_serial()), card)
    del outs

    # (c) execute_pipelined over four Q1-shaped queries, one a quarter
    q1s, wants = [], []
    for j, q in enumerate(quarters):
        sets = [[b for i, b in enumerate(q) if lo <= (j * quarter + i) % nb < hi] for lo, hi in Q1_THIRDS]
        head_bases = [(j * quarter + i) % nb for i in range(Q1_HEAD)]
        q1s.append(((Q.or_(*sets[0]) & Q.or_(*sets[1])) - Q.or_(*sets[2])) | Q.threshold(2, *q[:Q1_HEAD]))
        wants.append(np.union1d(np.setdiff1d(ab, uC), _at_least(base, head_bases, 2)))

    def check_q(label, outs):
        for j, (r, want) in enumerate(zip(outs, wants)):
            got = r.to_array()
            if got.shape != want.shape or not np.array_equal(got, want.astype(np.uint32)):
                fail(f"{label} Q1 of quarter {j}: {got.size} values, the numpy oracle {want.size}")

    qw = {"serial": [], "pipelined": []}
    ratios = []
    for kind in ("serial", "pipelined", "pipelined", "serial"):
        store.PACK_CACHE.close()
        overlap.LANE.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = (tq.execute_pipelined(q1s, cache=None) if kind == "pipelined"
                else [tq.execute(q, cache=None) for q in q1s])
        qw[kind].append(time.perf_counter() - t0)
        check_q(kind, outs)
        if kind == "pipelined":
            ratios.append(overlap.LANE.stats()["overlap_ratio"])
    say(f"[serving] execute_pipelined over 4 Q1-shaped queries (one a quarter, pack cache closed): "
        f"every result equal to the numpy oracle, as serial execute's; serial / pipelined in turns "
        f"(ms): serial {', '.join(f'{w * 1e3:.1f}' for w in qw['serial'])}; pipelined "
        f"{', '.join(f'{w * 1e3:.1f}' for w in qw['pipelined'])}; lane overlap ratio "
        f"{', '.join(f'{r:.4f}' for r in ratios)}  [{card}]")
    peak = torch.cuda.max_memory_allocated()
    say(f"[serving] peak device memory {peak / 2**30:.2f} GiB; phase {time.perf_counter() - t_phase:.1f} s  [{card}]")
    store.PACK_CACHE.close()
    torch.cuda.empty_cache()
    return lane_launches


# ---------------------------------------------------------------------------
# phase 11: the native host tier against its numpy tier
# ---------------------------------------------------------------------------

HOST_PAIRS = 2_000  # container pairs of the entry-point checks
# phase 9's window, cut for the tiers' turns (the numpy tier's and/andnot
# take ~1.0 and ~3.1 ms a pair); phase 9 runs the whole window on the native tier
HOST_WINDOW_PAIRS = 500
HOST_RUNS = 3  # turns of each tier per median
HOST_TIERS = ("native", "numpy")


def _cpu_model() -> str:
    """The CPU model as ``lscpu`` gives it (``/proc/cpuinfo``'s where lscpu
    has none) and the CPU count."""
    import os

    out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=60).stdout
    m = re.search(r"^Model name:\s*(.+)$", out, re.M)
    model = m.group(1).strip() if m else "unknown"
    if model == "unknown":
        try:
            with open("/proc/cpuinfo") as f:
                m = re.search(r"^model name\s*:\s*(.+)$", f.read(), re.M)
            model = f"lscpu: unknown; /proc/cpuinfo: {m.group(1).strip() if m else 'unknown'}"
        except OSError:
            pass
    return f"{model}, {os.cpu_count()} CPUs"


def _same(x, y) -> bool:
    """Exact equality of two results: arrays by dtype, shape and values,
    tuples item by item, scalars by value and type."""
    if isinstance(x, tuple):
        return isinstance(y, tuple) and len(x) == len(y) and all(_same(a, b) for a, b in zip(x, y))
    if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        x, y = np.asarray(x), np.asarray(y)
        return x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)
    return type(x) is type(y) and x == y


def _wall(fn, calls):
    """(seconds, results) of ``fn(*args)`` over every args tuple of ``calls``."""
    t0 = time.perf_counter()
    out = [fn(*a) for a in calls]
    return time.perf_counter() - t0, out


def _tier_turns(fn, runs: int = HOST_RUNS) -> dict:
    """``{tier: [fn(tier) per run]}``, the two host tiers taking turns
    within each run; the native tier is restored after."""
    from roaringbitmap_tpu_torch import native

    out = {t: [] for t in HOST_TIERS}
    try:
        for _ in range(runs):
            for tier in HOST_TIERS:
                native.set_tier(tier)
                out[tier].append(fn(tier))
    finally:
        native.set_tier("native")
    return out


def _med_ms(walls) -> str:
    return f"{np.median(walls) * 1e3:.1f} ({min(walls) * 1e3:.1f}-{max(walls) * 1e3:.1f})"


def _host_inputs(bitmaps, nb: int):
    """Census-shaped inputs: the matched containers of adjacent base
    bitmaps, as sorted uint16 values (HOST_PAIRS pairs)."""
    a_list, b_list = [], []
    for i in range(nb - 1):
        x, y = bitmaps[i].high_low_container, bitmaps[i + 1].high_low_container
        ky = dict(zip(y.keys, y.containers))
        for k, c in zip(x.keys, x.containers):
            if k in ky:
                a_list.append(np.ascontiguousarray(c.to_array(), dtype=np.uint16))
                b_list.append(np.ascontiguousarray(ky[k].to_array(), dtype=np.uint16))
        if len(a_list) >= HOST_PAIRS:
            break
    return a_list[:HOST_PAIRS], b_list[:HOST_PAIRS]


def _host_entry_points(bitmaps, nb: int, card: str, cpu: str):
    """Every ``rb_*`` entry point on each binding that serves it (the
    extension, ctypes) against its numpy version on the same census-shaped
    inputs: exact results required; each timed over the whole input set.
    Returns the ``host_tier`` entries."""
    from roaringbitmap_tpu_torch import native
    from roaringbitmap_tpu_torch.columnar import kernels as ck
    from roaringbitmap_tpu_torch.parallel import store
    from roaringbitmap_tpu_torch.utils import bits

    _lib, ext = native.load()
    A, B = _host_inputs(bitmaps, nb)
    n = len(A)
    words = [bits.words_from_values_numpy(a) for a in A]
    runs = [bits.runs_from_values_numpy(a) for a in A]
    probes = [(a, int(b[0]) if b.size else 0) for a, b in zip(A, B)]
    ab = list(zip(A, B))

    def searched(a, x):
        i = int(np.searchsorted(a, np.uint16(x)))
        return bool(i < a.size and a[i] == x)

    def run_has(st, ln, x):
        i = int(np.searchsorted(st, x, side="right")) - 1
        return bool(i >= 0 and x - int(st[i]) <= int(ln[i]))

    def or_into(acc, v):
        return bits.or_values_into_words_numpy(acc.copy(), v)

    def or_into_native(acc, v):
        return native.or_values_into_words(acc.copy(), v)

    acc0 = bits.words_from_values_numpy(np.arange(0, 1 << 16, 97, dtype=np.uint16))
    # (entry point, wrapper, numpy version, calls, bindings: name -> function)
    per_call = [
        ("rb_intersect_u16", "intersect_sorted", bits.intersect_sorted_numpy, ab, None),
        ("rb_union_u16", "merge_sorted_unique", bits.merge_sorted_unique_numpy, ab, None),
        ("rb_difference_u16", "difference_sorted", bits.difference_sorted_numpy, ab, None),
        ("rb_xor_u16", "xor_sorted", bits.xor_sorted_numpy, ab, None),
        ("rb_intersect_card_u16", "intersect_cardinality",
         lambda a, b: int(bits.intersect_sorted_numpy(a, b).size), ab, None),
        ("rb_contains_many_u16", "contains_many", lambda a, b: np.isin(b, a), ab, None),
        ("rb_advance_until", "advance_until", lambda a, _pos, x: int(np.searchsorted(a, np.uint16(x))),
         [(a, -1, x) for a, x in probes], None),
        ("rb_advance_until", "lower_bound", bits.lower_bound_numpy, probes, None),
        ("rb_advance_until", "contains_u16", searched, probes, {"ext": ext.contains_u16}),
        ("rb_words_from_values", "words_from_values", bits.words_from_values_numpy, [(a,) for a in A], None),
        ("rb_words_from_values", "or_values_into_words", or_into, [(acc0, b) for b in B],
         {"ctypes": or_into_native}),
        ("rb_popcount_words", "cardinality_of_words", bits.cardinality_of_words_numpy, [(w,) for w in words], None),
        ("rb_values_from_words", "values_from_words", bits.values_from_words_numpy, [(w,) for w in words], None),
        ("rb_num_runs_words", "num_runs_in_words", bits.num_runs_in_words_numpy, [(w,) for w in words], None),
        ("rb_select_words", "select_in_words", bits.select_in_words_numpy,
         [(w, a.size // 2) for w, a in zip(words, A) if a.size], None),
        ("rb_cardinality_in_range", "cardinality_in_range", bits.cardinality_in_range_numpy,
         [(w, 1000, 40000) for w in words], None),
        ("word_bit", "word_bit", lambda w, x: bool(bits.get_bit(w, x)),
         [(w, x) for w, (_a, x) in zip(words, probes)], {"ext": ext.word_bit}),
        ("rb_runs_from_values", "runs_from_values", bits.runs_from_values_numpy, [(a,) for a in A], None),
        ("rb_num_runs_values", "num_runs_in_values", lambda a: int(bits.runs_from_values_numpy(a)[0].size),
         [(a,) for a in A], None),
        ("rb_advance_until", "run_contains", run_has,
         [(st, ln, x) for (st, ln), (_a, x) in zip(runs, probes)], {"ext": ext.run_contains}),
        ("rb_words_from_intervals", "words_from_intervals", bits.words_from_intervals_numpy,
         [(st.astype(np.int64), st.astype(np.int64) + ln + 1) for st, ln in runs], None),
        ("is_strictly_increasing", "validate_sorted_u16", bits.validate_sorted_u16_numpy, [(a,) for a in A], None),
        ("runs_valid", "validate_runs_u16", bits.validate_runs_u16_numpy,
         [(np.stack([st, ln], axis=1).reshape(-1),) for st, ln in runs], None),
    ]
    rows64 = np.stack(words[:256])
    for op in ("or", "and", "xor"):
        fn = {"or": np.bitwise_or, "and": np.bitwise_and, "xor": np.bitwise_xor}[op]

        def plain(r, o, fn=fn):
            w = fn.reduce(r, axis=0)
            return w, bits.cardinality_of_words_numpy(w)

        per_call.append((f"rb_wide_op_words[{op}]", "wide_op_words", plain, [(rows64, op)], None))
    entries = []
    for entry, wrapper, plain, calls, bindings in per_call:
        t_np, want = _wall(plain, calls)
        if bindings is None:
            bindings = {k: d[wrapper] for k, d in (("ext", native.EXT), ("ctypes", native.CTYPES)) if wrapper in d}
            bindings = bindings or {"ctypes": getattr(native, wrapper)}
        for binding, fn in bindings.items():
            t_nat, got = _wall(fn, calls)
            bad = next((i for i, (g, w) in enumerate(zip(got, want)) if not _same(g, w)), None)
            if bad is not None:
                fail(f"host tier {entry} ({wrapper}, {binding}): call {bad} differs from the numpy version")
            entries.append({"entry": entry, "wrapper": wrapper, "binding": binding, "calls": len(calls),
                            "native_ms": t_nat * 1e3, "numpy_ms": t_np * 1e3, "exact": True})

    # the batch entry points, one call over the whole batch
    def csr(sets):
        return (np.concatenate(sets).astype(np.uint16),
                np.concatenate(([0], np.cumsum([s.size for s in sets]))).astype(np.int64))

    av, ao = csr(A)
    bv, bo = csr(B)
    alen, blen = np.diff(ao), np.diff(bo)

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        return time.perf_counter() - t0, out

    def add(entry, wrapper, t_nat, t_np, ok, calls=1):
        if not ok:
            fail(f"host tier {entry} ({wrapper}): the batch differs from the numpy version")
        entries.append({"entry": entry, "wrapper": wrapper, "binding": "ctypes", "calls": calls,
                        "native_ms": t_nat * 1e3, "numpy_ms": t_np * 1e3, "exact": True})

    for op in PAIR_OPS:
        t_np, (vals, starts, counts) = timed(ck.batch_pairwise_numpy, av, ao, bv, bo, op)
        bound = {"and": np.minimum(alen, blen), "andnot": alen}.get(op, alen + blen)
        oo = np.concatenate(([0], np.cumsum(bound)))
        t_nat, (out, got_c) = timed(native.batch_pairwise_u16, av, ao, bv, bo, op, oo[:-1], int(oo[-1]))
        keep = np.repeat(oo[:-1], got_c) + (np.arange(int(got_c.sum())) - np.repeat(np.cumsum(got_c) - got_c, got_c))
        add(f"rb_batch_pairwise_u16[{op}]", "batch_pairwise_u16", t_nat, t_np,
            np.array_equal(got_c, counts) and np.array_equal(out[keep], vals))
    rs, rl = np.concatenate([st for st, _ in runs]), np.concatenate([ln for _, ln in runs])
    rc = np.array([st.size for st, _ in runs], np.int64)
    b_runs = [bits.runs_from_values_numpy(b) for b in B]
    bs_, bl = np.concatenate([s for s, _ in b_runs]), np.concatenate([l for _, l in b_runs])
    bc = np.array([s.size for s, _ in b_runs], np.int64)
    roffs, boffs2 = np.concatenate(([0], np.cumsum(rc))), np.concatenate(([0], np.cumsum(bc)))
    for op in ("and", "andnot"):
        t_np, cards = timed(ck.interval_batch, rs, rl, rc, bs_, bl, bc, op, True)
        t_nat, got = timed(native.batch_run_pairwise, rs, rl, roffs, bs_, bl, boffs2, op, None, 0)
        add(f"rb_batch_run_pairwise[{op}, cards only]", "batch_run_pairwise", t_nat, t_np,
            np.array_equal(got[3], cards))
        t_np, (o_s, o_e, o_st, o_c) = timed(ck.interval_batch, rs, rl, rc, bs_, bl, bc, op)
        oo = np.concatenate(([0], np.cumsum(rc + bc)))
        t_nat, (n_s, n_l, n_c, n_cards) = timed(
            native.batch_run_pairwise, rs, rl, roffs, bs_, bl, boffs2, op, oo[:-1], int(oo[-1]))
        keep = np.repeat(oo[:-1], n_c) + (np.arange(int(n_c.sum())) - np.repeat(np.cumsum(n_c) - n_c, n_c))
        want_m = np.zeros((n, 1024), np.uint64)
        got_m = np.zeros((n, 1024), np.uint64)
        rows = np.arange(n, dtype=np.int64)
        ck.fill_intervals_rows_numpy(rows, np.concatenate(([0], np.cumsum(o_c))), o_s, o_e, want_m)
        ks = n_s[keep].astype(np.int64)
        ck.fill_intervals_rows_numpy(rows, np.concatenate(([0], np.cumsum(n_c))), ks,
                                     ks + n_l[keep].astype(np.int64) + 1, got_m)
        add(f"rb_batch_run_pairwise[{op}]", "batch_run_pairwise", t_nat, t_np,
            np.array_equal(got_m, want_m) and np.array_equal(n_cards, ck.popcount_rows_numpy(want_m)))
    t_np, want = timed(ck.batch_and_cardinality_numpy, av, ao, bv, bo)
    t_nat, got = timed(native.batch_intersect_card_u16, av, ao, bv, bo)
    add("rb_batch_intersect_card_u16", "batch_intersect_card_u16", t_nat, t_np, _same(got, want))
    mat = np.stack(words)
    t_np, want = timed(ck.popcount_rows_numpy, mat)
    t_nat, got = timed(native.popcount_rows, mat)
    add("rb_popcount_rows", "popcount_rows", t_nat, t_np, _same(got, want))
    rep_rows = (np.arange(n) % 256).astype(np.int64)  # rows repeat: fold accumulators
    start = np.stack(words[:256])
    for op in ("or", "xor", "clear"):
        want, got = start.copy(), start.copy()
        t_np, _ = timed(ck.scatter_values_rows_numpy, rep_rows, bo, bv, want, op)
        t_nat, _ = timed(native.scatter_values_rows, rep_rows, bo, bv, got, op)
        add(f"rb_scatter_values_rows[{op}]", "scatter_values_rows", t_nat, t_np, np.array_equal(got, want))
    b_st = bs_.astype(np.int64)
    b_en = b_st + bl.astype(np.int64) + 1
    for op in ("or", "xor"):
        want, got = start.copy(), start.copy()
        t_np, _ = timed(ck.fill_intervals_rows_numpy, rep_rows, boffs2, b_st, b_en, want, op)
        t_nat, _ = timed(native.fill_intervals_rows, rep_rows, boffs2, b_st, b_en, got, op)
        add(f"rb_fill_intervals_rows[{op}]", "fill_intervals_rows", t_nat, t_np, np.array_equal(got, want))
    perm = np.random.default_rng(SEED).permutation(n).astype(np.int64)
    want, got = np.zeros((n, 1024), np.uint64), np.zeros((n, 1024), np.uint64)
    t_np, _ = timed(ck.scatter_values_rows_numpy, perm, ao, av, want, "or")
    t_nat, _ = timed(native.pack_array_rows, perm, ao, av, got)
    add("rb_pack_array_rows", "pack_array_rows", t_nat, t_np, np.array_equal(got, want))
    # the delta repack's host expansion, whole, on each tier
    conts = [c for b in bitmaps[:nb] for c in b.high_low_container.containers][:HOST_PAIRS]
    walls = _tier_turns(lambda tier: timed(lambda: store.RowPayload.from_containers(conts).expand_host())[0])
    native.set_tier("numpy")
    want = store.RowPayload.from_containers(conts).expand_host()
    native.set_tier("native")
    if not np.array_equal(store.RowPayload.from_containers(conts).expand_host(), want):
        fail("RowPayload.expand_host differs between the host tiers")
    entries.append({"entry": "rb_pack_array_rows", "wrapper": "RowPayload.expand_host", "binding": "ctypes",
                    "calls": len(conts), "native_ms": float(np.median(walls["native"])) * 1e3,
                    "numpy_ms": float(np.median(walls["numpy"])) * 1e3, "exact": True})
    say(f"[host] {len(entries)} entry points and bindings, each exact against its numpy version on "
        f"{n} census container pairs ({int(ao[-1])} + {int(bv.size)} values); ms native / numpy, calls: "
        + "; ".join(f"{e['entry']} {e['wrapper']} {e['binding']} {e['native_ms']:.3f} / {e['numpy_ms']:.3f} "
                    f"x{e['calls']}" for e in entries) + f"  [{cpu}; {card}]")
    return entries


def phase_host(base, bitmaps, card: str):
    """The native host tier: every entry point on both bindings exact
    against numpy, then the slice's paths with the two host tiers taking
    turns: phase 9's window (cut to HOST_WINDOW_PAIRS) with its stages,
    the routed facade's ns per pair, Q1 cold and warm, and phase 10's
    fusion window cold and warm. Returns the ``host_tier`` entries."""
    from roaringbitmap_tpu_torch import RoaringBitmap, columnar, native
    from roaringbitmap_tpu_torch import query as tq
    from roaringbitmap_tpu_torch.columnar import device as cdev
    from roaringbitmap_tpu_torch.columnar import engine as E
    from roaringbitmap_tpu_torch.parallel import store

    t_phase = time.perf_counter()
    cpu = _cpu_model()
    say(f"[host] {cpu}; host tier {native.backend_tier()}  [{card}]")
    nb = len(base)
    entries = _host_entry_points(bitmaps, nb, card, cpu)

    # (b) phase 9's window, cut, the tiers in turns
    clones = [b.clone() for b in bitmaps[:HOST_WINDOW_PAIRS + 1]]
    for c in clones:
        c.run_optimize()
    pairs = list(zip(clones[:-1], clones[1:]))
    uniq = [np.unique(b).astype(np.uint32) for b in base]
    store.PACK_CACHE.close()
    for c in clones:
        cdev.rows_for(c)
    torch.cuda.synchronize()
    checked = set()

    def window(op):
        def run(tier):
            with _StageClock() as clock:
                t0 = time.perf_counter()
                out = columnar.pairwise_multi(op, pairs, tier="device")
                wall = time.perf_counter() - t0
            if tier not in checked:
                for i, r in enumerate(out):
                    want = SET_OPS[op](uniq[i % nb], uniq[(i + 1) % nb])
                    if not np.array_equal(r.to_array(), want):
                        fail(f"[host] pairwise_multi {op} on the {tier} tier: pair {i} differs from numpy")
                checked.add(tier)
            return wall, dict(clock.t)

        res = _tier_turns(run)
        checked.clear()
        return res

    for op in PAIR_OPS:
        res = window(op)
        parts = []
        for tier in HOST_TIERS:
            walls = [w for w, _ in res[tier]]
            st = {k: float(np.median([s[k] for _, s in res[tier]])) for k in WINDOW_STAGES}
            parts.append(f"{tier} median {_med_ms(walls)} ms, stages (median ms) "
                         + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in st.items()))
        say(f"[host] pairwise_multi {op} over {len(pairs)} pairs (device tier), {HOST_RUNS} runs, host tiers "
            f"in turns, every result equal to numpy: " + "; ".join(parts) + f"  [{cpu}; {card}]")

    # (c) the routed facade over the first 199 pairs: per-container walk and routed, per tier
    head = pairs[:FACADE_PAIRS]
    columnar.ensure_calibrated()
    for op in PAIR_OPS:
        routes0 = dict(E.ROUTE_COUNTS)
        fns = {"per-container": lambda x, y, op=op: _percontainer(op, x, y),
               "routed": getattr(RoaringBitmap, FACADE[op])}
        ns = _tier_turns(lambda tier: _pairs_ns(fns, head, 1))
        verdicts = {k: v - routes0[k] for k, v in E.ROUTE_COUNTS.items() if v != routes0[k]}
        parts = []
        for tier in HOST_TIERS:
            pc = float(np.median([r["per-container"] for r in ns[tier]]))
            ro = float(np.median([r["routed"] for r in ns[tier]]))
            parts.append(f"{tier}: per-container {pc:.0f}, routed {ro:.0f}, routed / per-container {ro / pc:.3f}")
        say(f"[host] facade {op} over {len(head)} pairs, ns per pair (median of {HOST_RUNS} turns, the walk "
            f"and the routed facade in turns within each): " + "; ".join(parts) + f"; verdicts {verdicts}  [{cpu}; {card}]")
    del clones, pairs, head
    store.PACK_CACHE.close()

    # (d) Q1 cold and warm, and phase 10's fusion window cold and warm
    win, _sets, _ab_node, _ab, _uc = _serving_window(base, bitmaps, tq.Q)
    q1, want_q1 = win[0][1], win[0][2]
    qs = [q for _n, q, _w in win]

    def check(label, outs, wants):
        for r, w in zip(outs, wants):
            if not np.array_equal(r.to_array(), w.astype(np.uint32)):
                fail(f"[host] {label}: a result differs from the numpy oracle")

    def q1_run(tier):
        store.PACK_CACHE.close()
        t0 = time.perf_counter()
        cold = tq.execute(q1, cache=None)
        t1 = time.perf_counter()
        warm = tq.execute(q1, cache=None)
        t2 = time.perf_counter()
        check(f"Q1 on the {tier} tier", [cold, warm], [want_q1, want_q1])
        return t1 - t0, t2 - t1

    def window_run(tier):
        store.PACK_CACHE.close()
        t0 = time.perf_counter()
        cold = tq.execute_fused(qs, cache=None)
        t1 = time.perf_counter()
        warm = tq.execute_fused(qs, cache=None)
        t2 = time.perf_counter()
        check(f"the fused window on the {tier} tier", cold + warm, [w for _n, _q, w in win] * 2)
        return t1 - t0, t2 - t1

    for label, fn in (("Q1 (execute, result cache off)", q1_run), ("fused window of 8", window_run)):
        res = _tier_turns(fn)
        say(f"[host] {label}, {HOST_RUNS} runs, host tiers in turns, every result equal to numpy: "
            + "; ".join(f"{tier} cold {_med_ms([c for c, _w in res[tier]])} ms, warm "
                        f"{_med_ms([w for _c, w in res[tier]])} ms" for tier in HOST_TIERS)
            + f"  [{cpu}; {card}]")
    store.PACK_CACHE.close()
    torch.cuda.empty_cache()
    say(f"[host] phase {time.perf_counter() - t_phase:.1f} s  [{card}]")
    return entries


# ---------------------------------------------------------------------------
# phase 6: the BSI north star
# ---------------------------------------------------------------------------


def _check_values(name, bm, oracle, tag="[bsi]"):
    got = bm.to_array()
    if got.shape != oracle.shape or not np.array_equal(got, oracle.astype(np.uint32)):
        fail(f"{name}: result ({got.size} values) differs from the numpy oracle ({oracle.size})")
    say(f"{tag} {name}: {got.size} values, equal to the numpy oracle")


def phase_bsi(card: str):
    """The 100M-row, 32-slice BSI through the port's entry points. Returns
    the values, the launch counts of the checked queries, the index (for
    phase 13, which maps its serialized bytes) and its first-query,
    compare and batched-count times."""
    from roaringbitmap_tpu_torch import Operation, RoaringBitmap, RoaringBitmapSliceIndex
    from roaringbitmap_tpu_torch.ops import device as dev
    from roaringbitmap_tpu_torch.ops import kernels as K
    from roaringbitmap_tpu_torch.parallel import store

    rng = np.random.default_rng(SEED)  # benchmarks/bsi.py:110-121
    t0 = time.perf_counter()
    cols = np.arange(BSI_ROWS, dtype=np.uint32)
    vals = rng.integers(0, 1 << 32, size=BSI_ROWS, dtype=np.uint64).astype(np.int64)
    index = RoaringBitmapSliceIndex()
    index.set_values((cols, vals))
    build_s = time.perf_counter() - t0
    found_cols = np.sort(rng.choice(BSI_ROWS, size=BSI_ROWS // 20, replace=False)).astype(np.int64)
    found = RoaringBitmap(found_cols.astype(np.uint32))
    # a found set that also reaches the ebm's last chunk past the last
    # column and four chunks outside the ebm
    outside = np.arange(BSI_ROWS, BSI_ROWS + 300_000, 7, dtype=np.int64)
    found2_cols = np.concatenate([found_cols, outside])
    found2 = RoaringBitmap(found2_cols.astype(np.uint32))
    del cols
    say(
        f"[bsi] built {BSI_ROWS} rows, {index.bit_count()} slices, "
        f"{index.ebm.get_container_count()} chunks through set_values in {build_s:.1f} s "
        f"(values uniform in [0, 2^32), seed {SEED:#x}); found set {found_cols.size} columns  [{card}]"
    )
    if index.bit_count() != S_BSI or index.ebm.get_container_count() != K_BSI:
        fail("the index does not have the north star's shape")
    med = int(np.median(vals))
    present = int(vals[12_345])
    lo, hi = med // 2, med + med // 2
    fv = vals[found_cols]
    q_vals = np.quantile(vals, np.linspace(0.05, 0.95, BATCH_Q)).astype(np.int64)  # :163
    neq2 = np.concatenate([found_cols[fv != present], outside])
    queries = [
        ("GE median", Operation.GE, med, 0, None, np.flatnonzero(vals >= med)),
        ("RANGE middle half", Operation.RANGE, lo, hi, None,
         np.flatnonzero((vals >= lo) & (vals <= hi))),
        ("GE median, 5% found set", Operation.GE, med, 0, found, found_cols[fv >= med]),
        ("EQ a present value", Operation.EQ, present, 0, None, np.flatnonzero(vals == present)),
        ("NEQ a present value", Operation.NEQ, present, 0, None, np.flatnonzero(vals != present)),
        ("GT median", Operation.GT, med, 0, None, np.flatnonzero(vals > med)),
        ("LT median", Operation.LT, med, 0, None, np.flatnonzero(vals < med)),
        ("LE median", Operation.LE, med, 0, None, np.flatnonzero(vals <= med)),
        ("NEQ with a found set outside the ebm", Operation.NEQ, present, 0, found2, neq2),
    ]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    # --- the BSI path: every query below runs with the counts live ---
    t0 = time.perf_counter()
    first = index.compare(Operation.GE, med)
    t_first = time.perf_counter() - t0
    _check_values("compare GE median (first query, pack + copy)", first, queries[0][5])
    del first
    for name, op, a, b, fs, oracle in queries:
        _check_values(f"compare {name}", index.compare(op, a, b, fs), oracle)
        cnt = index.compare_cardinality(op, a, b, fs)
        if cnt != oracle.size:
            fail(f"compare_cardinality {name} = {cnt}, oracle {oracle.size}")
    say(f"[bsi] compare_cardinality of all {len(queries)} queries equal to the oracle")
    many = index.compare_cardinality_many(Operation.GE, q_vals)
    srt = np.sort(vals)
    want_many = BSI_ROWS - np.searchsorted(srt, q_vals, side="left")
    if not np.array_equal(many, want_many):
        fail(f"compare_cardinality_many GE over {BATCH_Q} quantiles differs from the oracle")
    say(f"[bsi] compare_cardinality_many GE over {BATCH_Q} quantile thresholds: equal to the oracle")
    total, count = index.sum(found)
    if (total, count) != (int(fv.sum()), found_cols.size):
        fail(f"sum(found) = {(total, count)}, oracle {(int(fv.sum()), found_cols.size)}")
    say(f"[bsi] sum(found) = {total} over {count} columns, equal to the oracle")
    launches = dict(K.LAUNCHES)
    say(f"[bsi] launches over the BSI path: {launches}")
    for name in ("rb_oneil_compare", "rb_oneil_compare[batched]", "rb_popcount_rows[masked]"):
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on the BSI path")
    # one compare_cardinality_many, one launch of the tiled walk; the index
    # is far shallower than the tile's limit
    if launches["rb_oneil_compare[batched]"] != 1 or launches["rb_oneil_compare[batched-deep]"]:
        fail(f"compare_cardinality_many did not take one tiled launch: {launches}")
    peak_queries = torch.cuda.max_memory_allocated()
    del srt

    # --- timing on the resident pack ---
    keys, ebm_w, slices_w = index._pack_dense()
    bits = _bits_tensor([[_pred_bits(med, S_BSI)]])
    steady = cuda_ms(lambda: K.oneil_compare(slices_w, bits, ebm_w, ebm_w, "GE"))
    # the batched count's kernel on the resident pack, at the 64 quantiles
    bits_q = _bits_tensor(_walks("GE", [int(v) for v in q_vals], S_BSI))
    steady_many = cuda_ms(lambda: K.oneil_compare(slices_w, bits_q, ebm_w, ebm_w, "GE", True))
    clocks = smi_clocks()
    fields = clocks.split(",")
    mhz = _mhz(fields[1]) if len(fields) == 4 else 1980.0
    b_many, by, b_bytes, b_ops = batched_bound(S_BSI, K_BSI, BATCH_Q, True, mhz)
    word_ops = oneil_word_ops(bits_q.cpu().numpy())
    walk = ops_bound_ms(word_ops, K_BSI, mhz)
    say(
        f"[bsi] steady rb_oneil_compare[batched] GE over the {BATCH_Q} quantile thresholds on the "
        f"resident pack: {steady_many:.4f} ms ({REPS} reps); byte bound {b_bytes:.4f} ms, operation "
        f"bound {b_ops:.4f} ms: {by} bind, {b_many / steady_many:.1%} of the bound; the walk's own "
        f"floor {walk:.4f} ms ({word_ops / (BATCH_Q * S_BSI):.4f} logic instructions per word-step): "
        f"{walk / steady_many:.1%} of it; clocks.sm, clocks.max.sm, power.draw, power.limit after: "
        f"{clocks}  [{card}]"
    )
    # one instrumented pass of compare GE: each stage timed on its own
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _keys, out, cards, _ = index._o_neil_device_walk(Operation.GE, med, None)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    words_host, cards_host = dev.to_host_u32(out), cards.cpu().numpy().astype(np.int64)
    t2 = time.perf_counter()
    store.unpack_to_bitmap(np.asarray(_keys, dtype=np.int64), words_host, cards_host)
    t3 = time.perf_counter()
    say(
        f"[bsi] compare GE stages: bits + launch + kernel {(t1 - t0) * 1e3:.3f} ms, "
        f"result words and cards to the host ({words_host.nbytes} bytes, pageable) "
        f"{(t2 - t1) * 1e3:.3f} ms, unpack_to_bitmap ({len(_keys)} containers) "
        f"{(t3 - t2) * 1e3:.3f} ms  [{card}]"
    )
    del out, cards, words_host, cards_host
    walls = []
    for _ in range(E2E_RUNS):
        t0 = time.perf_counter()
        index.compare(Operation.GE, med)  # returns a host bitmap: the work is done
        walls.append(time.perf_counter() - t0)
    e2e = float(np.median(walls))

    def tiers_run(tier):
        t0 = time.perf_counter()
        r = index.compare(Operation.GE, med)
        t1 = time.perf_counter()
        k_, out_, cards_, _ = index._o_neil_device_walk(Operation.GE, med, None)
        w_, c_ = dev.to_host_u32(out_), cards_.cpu().numpy().astype(np.int64)
        t2 = time.perf_counter()
        u = store.unpack_to_bitmap(np.asarray(k_, dtype=np.int64), w_, c_)
        t3 = time.perf_counter()
        if r.get_cardinality() != queries[0][5].size or u.get_cardinality() != queries[0][5].size:
            fail(f"compare GE median on the {tier} host tier: wrong cardinality")
        return t1 - t0, t3 - t2

    turns = _tier_turns(tiers_run, E2E_RUNS // 2)
    say(f"[bsi] compare GE median end to end and its unpack_to_bitmap, host tiers in turns "
        f"({E2E_RUNS // 2} runs each, ms): "
        + "; ".join(f"{tier} compare {_med_ms([a for a, _b in turns[tier]])}, unpack "
                    f"{_med_ms([b for _a, b in turns[tier]])}" for tier in HOST_TIERS)
        + f"  [{_cpu_model()}; {card}]")
    t0 = time.perf_counter()
    index.compare_cardinality_many(Operation.GE, q_vals)
    t_many = time.perf_counter() - t0
    t0 = time.perf_counter()
    loop = [index.compare_cardinality(Operation.GE, int(v)) for v in q_vals]
    t_loop = time.perf_counter() - t0
    if not np.array_equal(np.asarray(loop), want_many):
        fail("the looped compare_cardinality differs from the oracle")
    peak = torch.cuda.max_memory_allocated()
    _profiled("[bsi]", "compare GE median", lambda: index.compare(Operation.GE, med), card, 5)
    _profiled(
        "[bsi]", f"compare_cardinality_many GE x{BATCH_Q}",
        lambda: index.compare_cardinality_many(Operation.GE, q_vals), card, 5,
    )
    b = bound_ms(_oneil_bytes(S_BSI, K_BSI, 1, True, False))  # fixed is the ebm
    say(
        f"[bsi] first query (pack build + copy + kernel + unpack) {t_first * 1e3:.1f} ms; "
        f"steady rb_oneil_compare GE on the resident pack {steady:.4f} ms ({REPS} reps, bound "
        f"{b:.4f} ms); compare GE end to end (resident pack to host RoaringBitmap), "
        f"{E2E_RUNS} runs: median {e2e * 1e3:.2f} ms (min {min(walls) * 1e3:.2f}, max "
        f"{max(walls) * 1e3:.2f}), {1 / e2e:.2f} queries/s  [{card}]"
    )
    say(
        f"[bsi] compare_cardinality_many GE, {BATCH_Q} thresholds in one launch: "
        f"{t_many * 1e3:.2f} ms, {t_many / BATCH_Q * 1e9:.0f} ns/query; a loop of "
        f"{BATCH_Q} compare_cardinality: {t_loop * 1e3:.2f} ms, {t_loop / BATCH_Q * 1e9:.0f} "
        f"ns/query; peak device memory {peak / 2**30:.3f} GiB ({peak} bytes; "
        f"{peak_queries} bytes over the checked queries)  [{card}]"
    )
    del keys, ebm_w, slices_w
    torch.cuda.empty_cache()
    times = {"first_ms": t_first * 1e3, "compare_ms": e2e * 1e3, "many_ns": t_many / BATCH_Q * 1e9}
    return vals, launches, index, times


# ---------------------------------------------------------------------------
# phase 7: RangeBitmap at an earlier depth, correctness only
# ---------------------------------------------------------------------------


def phase_range_bitmap(vals):
    from roaringbitmap_tpu_torch import RangeBitmap
    from roaringbitmap_tpu_torch.ops import kernels as K

    rows = vals[:RANGE_ROWS].astype(np.uint64)
    t0 = time.perf_counter()
    app = RangeBitmap.appender((1 << 32) - 1)
    app.add_many(rows)
    rb = app.build()
    blob = rb.serialize()
    mapped = RangeBitmap.map(blob)
    say(
        f"[range] {RANGE_ROWS} rows appended, sealed and serialized ({len(blob)} bytes, "
        f"reference format) in {time.perf_counter() - t0:.1f} s"
    )
    med = int(np.median(rows))
    lo, hi = med // 3, med + med // 3
    qs = np.quantile(rows, np.linspace(0.1, 0.9, 16)).astype(np.int64)
    srt = np.sort(rows)
    K.reset_launches()
    for label, r in (("built", rb), ("mapped from the reference bytes", mapped)):
        _check_values(
            f"RangeBitmap {label} gte(median)", r.gte(med), np.flatnonzero(rows >= med), "[range]"
        )
        _check_values(
            f"RangeBitmap {label} between", r.between(lo, hi),
            np.flatnonzero((rows >= lo) & (rows <= hi)), "[range]",
        )
        got = r.gte_cardinality_many(qs)
        want = RANGE_ROWS - np.searchsorted(srt, qs.astype(np.uint64), side="left")
        if not np.array_equal(got, want):
            fail(f"RangeBitmap {label} gte_cardinality_many differs from the oracle")
        got = r.between_cardinality_many(qs, qs + 10_000_000)
        want = np.searchsorted(srt, (qs + 10_000_000).astype(np.uint64), side="right") - np.searchsorted(
            srt, qs.astype(np.uint64), side="left")
        if not np.array_equal(got, want):
            fail(f"RangeBitmap {label} between_cardinality_many differs from the oracle")
        say(f"[range] RangeBitmap {label}: gte/between_cardinality_many equal to the oracle")
    if RangeBitmap.map(mapped.serialize()).serialize() != blob:
        fail("RangeBitmap bytes do not round-trip through map")
    # the native form: every slice a zero-copy ImmutableRoaringBitmap view
    from roaringbitmap_tpu_torch import ImmutableRoaringBitmap
    from roaringbitmap_tpu_torch.models.container import ArrayContainer, BitmapContainer

    native_blob = rb.serialize(form="native")
    nmap = RangeBitmap.map(native_blob)
    lo = np.frombuffer(native_blob, dtype=np.uint8).ctypes.data
    hi = lo + len(native_blob)
    n_views = 0
    for i in range(nmap._slice_count):
        s = nmap._slice(i)
        if type(s) is not ImmutableRoaringBitmap or s._buf.obj is not native_blob:
            fail(f"RangeBitmap native-form slice {i} is not a view of the source buffer")
        for c in s.high_low_container.containers:
            arrays = ((c.words,) if type(c) is BitmapContainer
                      else (c.content,) if type(c) is ArrayContainer else (c.starts, c.lengths))
            for arr in arrays:
                if arr.size and not lo <= arr.ctypes.data < hi:
                    fail(f"RangeBitmap native-form slice {i}: a container payload was copied")
            n_views += 1
    _check_values("RangeBitmap mapped from the native bytes gte(median)", nmap.gte(med),
                  np.flatnonzero(rows >= med), "[range]")
    if not np.array_equal(nmap.gte_cardinality_many(qs), RANGE_ROWS - np.searchsorted(srt, qs.astype(np.uint64), side="left")):
        fail("RangeBitmap mapped from the native bytes: gte_cardinality_many differs from the oracle")
    if nmap.serialize() != native_blob:
        fail("RangeBitmap native bytes do not round-trip through map")
    say(f"[range] native form ({len(native_blob)} bytes) mapped: {nmap._slice_count} slices, "
        f"{n_views} container payloads, all views of the source buffer (none copied)")
    if K.LAUNCHES["rb_oneil_compare"] == 0 or K.LAUNCHES["rb_oneil_compare[batched]"] == 0:
        fail(f"RangeBitmap queries did not run through rb_oneil_compare: {K.LAUNCHES}")
    say(f"[range] launches: {dict(K.LAUNCHES)}")


# ---------------------------------------------------------------------------
# phase 13: memory-mapped bitmaps (the buffer package)
# ---------------------------------------------------------------------------

MAPPED_RUNS = 5  # cold runs per median of the mapped wide OR (each repacks 2.52 GB of rows)


def _write_blobs(path, blobs):
    """The blobs back to back in one file; returns each one's (offset, length)."""
    extents = []
    with open(path, "wb") as f:
        for blob in blobs:
            extents.append((f.tell(), len(blob)))
            f.write(blob)
    return extents


def _map_file(path):
    """The whole file mapped read-only (ACCESS_READ), as a memoryview."""
    import mmap

    with open(path, "rb") as f:
        return memoryview(mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ))


def _map_bitmaps(view, extents):
    """One ImmutableRoaringBitmap over each extent of a mapping (header
    parses only); returns (bitmaps, seconds)."""
    from roaringbitmap_tpu_torch import ImmutableRoaringBitmap

    t0 = time.perf_counter()
    out = [ImmutableRoaringBitmap(view[o : o + n]) for o, n in extents]
    return out, time.perf_counter() - t0


def _unaligned_entry_points(mapped, card: str) -> None:
    """Every per-container native entry point, on both bindings, on mapped
    bitmap words at addresses 2, 4 and 6 (mod 8) and on mapped array
    values, against its numpy version on an aligned copy: exact."""
    from roaringbitmap_tpu_torch import native
    from roaringbitmap_tpu_torch.models.container import ArrayContainer, BitmapContainer
    from roaringbitmap_tpu_torch.utils import bits

    _, ext = native.load()
    words_at, arrays = {}, []
    for m in mapped[:400]:
        for c in m.high_low_container.containers:
            if type(c) is BitmapContainer:
                words_at.setdefault(c.words.ctypes.data % 8, c.words)
            elif type(c) is ArrayContainer and c.content.size > 200 and len(arrays) < 2:
                arrays.append(c.content)
    if not {2, 4, 6} <= set(words_at) or len(arrays) < 2:
        fail(f"the mapped file has bitmap words at residues {sorted(words_at)} (mod 8), "
             f"{len(arrays)} long arrays: not the unaligned cases")
    a, b = arrays
    ac, bc = a.copy(), b.copy()
    n_calls = 0
    for residue in (2, 4, 6):
        w = words_at[residue]
        wc = w.copy()
        for name, args, plain in (
            ("cardinality_of_words", (w,), lambda: bits.cardinality_of_words_numpy(wc)),
            ("values_from_words", (w,), lambda: bits.values_from_words_numpy(wc)),
            ("num_runs_in_words", (w,), lambda: bits.num_runs_in_words_numpy(wc)),
            ("select_in_words", (w, 100), lambda: bits.select_in_words_numpy(wc, 100)),
            ("cardinality_in_range", (w, 3, 50_001), lambda: bits.cardinality_in_range_numpy(wc, 3, 50_001)),
            ("words_from_values", (a,), lambda: bits.words_from_values_numpy(ac)),
            ("intersect_sorted", (a, b), lambda: bits.intersect_sorted_numpy(ac, bc)),
            ("merge_sorted_unique", (a, b), lambda: bits.merge_sorted_unique_numpy(ac, bc)),
            ("difference_sorted", (a, b), lambda: bits.difference_sorted_numpy(ac, bc)),
            ("xor_sorted", (a, b), lambda: bits.xor_sorted_numpy(ac, bc)),
            ("intersect_cardinality", (a, b), lambda: int(bits.intersect_sorted_numpy(ac, bc).size)),
            ("contains_many", (a, b), lambda: np.isin(bc, ac)),
            ("advance_until", (a, 5, int(a[100])), lambda: 100),
        ):
            want = plain()
            for binding, fn in (("ext", native.EXT[name]), ("ctypes", native.CTYPES[name])):
                got = fn(*args)
                n_calls += 1
                if not np.array_equal(np.asarray(got), np.asarray(want)):
                    fail(f"native {name} ({binding}) on words at residue {residue} (mod 8) differs from numpy")
        for x in (0, 63, 64, 4097, 65535):
            if ext.word_bit(w, x) != bits.get_bit(wc, x):
                fail(f"the extension's word_bit on words at residue {residue} differs from numpy")
        out, cnt = native.wide_op_words(np.stack([w, w]), "or")
        if not np.array_equal(out, wc) or not np.array_equal(native.popcount_rows(np.stack([w, w])), np.array([cnt, cnt])):
            fail(f"wide_op_words / popcount_rows on words at residue {residue} differ from numpy")
        n_calls += 5 + 2
    say(f"[mapped] native entry points on mapped words at residues 2, 4, 6 (mod 8), both bindings: "
        f"{n_calls} calls, all equal to numpy  [{_cpu_model()}; {card}]")


def phase_mapped(base, index, vals, bsi_times, card: str):
    """Phase 13: the census bitmaps and the BSI north star served from one
    memory-mapped file each, through the buffer package's entry points."""
    import os
    import tempfile

    from roaringbitmap_tpu_torch import (
        BufferFastAggregation,
        BufferParallelAggregation,
        FastAggregation,
        ImmutableBitSliceIndex,
        MutableRoaringBitmap,
        Operation,
        RoaringBitmap,
    )
    from roaringbitmap_tpu_torch.ops import device as dev
    from roaringbitmap_tpu_torch.ops import kernels as K
    from roaringbitmap_tpu_torch.parallel import aggregation, store

    if aggregation.config.device != "cuda":
        fail(f"aggregation.config.device is {aggregation.config.device!r}, expected 'cuda'")
    t_phase = time.perf_counter()
    store.PACK_CACHE.close()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    nb = len(base)
    tmp = tempfile.TemporaryDirectory(prefix="rb_mapped_")
    path = os.path.join(tmp.name, "census.bin")
    t0 = time.perf_counter()
    base_blobs = [RoaringBitmap(v).serialize() for v in base]
    blobs = [base_blobs[i % nb] for i in range(N_BITMAPS)]
    extents = _write_blobs(path, blobs)
    t_write = time.perf_counter() - t0
    size = os.path.getsize(path)
    say(f"[mapped] {N_BITMAPS} census bitmaps serialized into one file: {size} bytes ({nb} base "
        f"bitmaps {sum(len(b) for b in base_blobs)} bytes, cycled {N_BITMAPS // nb} times), "
        f"written in {t_write:.2f} s")

    # the heap path and numpy on the same 10,000 bitmaps
    heap = [RoaringBitmap.deserialize(b) for b in blobs]
    oracle_or = np.unique(np.concatenate(list(base)))
    mult = np.bincount(np.arange(N_BITMAPS - 1) % nb, minlength=nb)
    odd = [base[i] for i in np.flatnonzero(mult % 2)]
    oracle_xor = _count_oracle(odd, len(odd))[1]
    oracle_and = _count_oracle([np.unique(v) for v in base], nb)[0]
    # XOR over all but the last bitmap, as in phase 4: copies cancel in
    # pairs, so every row changes the answer
    entry = {
        "or_": (lambda bms: BufferFastAggregation.or_(*bms, mode="device"), oracle_or),
        "xor": (lambda bms: BufferFastAggregation.xor(*bms[:-1], mode="device"), oracle_xor),
        "and_ (workShy)": (lambda bms: BufferFastAggregation.and_(*bms, mode="device"), oracle_and),
        "or_cardinality": (lambda bms: BufferFastAggregation.or_cardinality(*bms, mode="device"), oracle_or),
        "BufferParallelAggregation.or_": (lambda bms: BufferParallelAggregation.or_(*bms, mode="device"), oracle_or),
    }
    store.PACK_CACHE.close()
    want_bytes = {
        "or_": FastAggregation.or_(*heap, mode="device").serialize(),
        "xor": FastAggregation.xor(*heap[:-1], mode="device").serialize(),
        "and_ (workShy)": FastAggregation.and_(*heap, mode="device").serialize(),
    }
    want_bytes["BufferParallelAggregation.or_"] = want_bytes["or_"]
    store.PACK_CACHE.close()

    def check(label, name, got):
        oracle = entry[name][1]
        if isinstance(got, int):
            if got != oracle.size:
                fail(f"{label} {name} = {got}, oracle {oracle.size}")
            return
        if type(got) is not MutableRoaringBitmap:
            fail(f"{label} {name} returned {type(got).__name__}, not MutableRoaringBitmap")
        arr = got.to_array()
        if arr.shape != oracle.shape or not np.array_equal(arr, oracle):
            fail(f"{label} {name}: {arr.size} values, the numpy oracle {oracle.size}")
        if got.serialize() != want_bytes[name]:
            fail(f"{label} {name}: serialized bytes differ from the heap path's")

    # --- the mapped path, counts zeroed just before and read just after ---
    K.reset_launches()
    view1 = _map_file(path)
    mapped1, t_parse1 = _map_bitmaps(view1, extents)
    walls = {}
    for name, (fn, _) in entry.items():
        store.PACK_CACHE.close()
        t0 = time.perf_counter()
        got = fn(mapped1)
        walls[name] = time.perf_counter() - t0
        check("first mapping, cold", name, got)
    say(f"[mapped] first mapping ({t_parse1 * 1e3:.1f} ms to parse {N_BITMAPS} headers; the file's pages "
        f"as the write left them in the page cache), cold (pack cache closed before each; the first "
        f"call also builds the container views), ms: "
        + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in walls.items())
        + f"; every result equal to the heap path's bytes and numpy  [{card}]")
    view2 = _map_file(path)
    mapped2, t_parse2 = _map_bitmaps(view2, extents)
    walls2 = {}
    for name, (fn, _) in entry.items():
        store.PACK_CACHE.close()
        t0 = time.perf_counter()
        got = fn(mapped2)
        walls2[name] = time.perf_counter() - t0
        check("second mapping, cold", name, got)
    say(f"[mapped] second mapping of the same file ({t_parse2 * 1e3:.1f} ms to parse), cold, ms: "
        + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in walls2.items()) + f"  [{card}]")
    # warm: the resident pack under the mapped arrays' ("static", id) keys
    store.PACK_CACHE.close()
    BufferFastAggregation.or_(*mapped2, mode="device")
    BufferFastAggregation.or_(*mapped2, mode="device")  # second touch: the padded block
    agg = dict(store.PACK_CACHE.stats()["kinds"]["agg"])
    if any(m.fingerprint() != ("static", id(m.high_low_container)) for m in mapped2[:100]):
        fail("a mapped bitmap's fingerprint is not its static array identity")
    warm = []
    for _ in range(E2E_RUNS):
        t0 = time.perf_counter()
        got = BufferFastAggregation.or_(*mapped2, mode="device")
        warm.append(time.perf_counter() - t0)
    check("warm", "or_", got)
    check("warm", "or_cardinality", BufferFastAggregation.or_cardinality(*mapped2, mode="device"))
    check("warm", "BufferParallelAggregation.or_", BufferParallelAggregation.or_(*mapped2, mode="device"))
    agg2 = store.PACK_CACHE.stats()["kinds"]["agg"]
    hits, misses = agg2["hits"] - agg["hits"], agg2["misses"] - agg["misses"]
    if (hits, misses) != (E2E_RUNS + 2, 0):
        fail(f"the warm mapped runs took {hits} pack-cache hits and {misses} misses, "
             f"expected {E2E_RUNS + 2} hits and none")
    # mixed operands: half heap, half mapped
    mixed = [heap[i] if i % 2 == 0 else mapped2[i] for i in range(N_BITMAPS)]
    wallsm = {}
    for name, (fn, _) in entry.items():
        store.PACK_CACHE.close()
        t0 = time.perf_counter()
        got = fn(mixed)
        wallsm[name] = time.perf_counter() - t0
        check("mixed heap and mapped", name, got)
    launches = dict(K.LAUNCHES)
    say(f"[mapped] warm (resident pack, {hits} hits, 0 misses): or_ median "
        f"{float(np.median(warm)) * 1e3:.2f} ms over {E2E_RUNS} runs; mixed (every other bitmap heap), "
        f"cold, ms: " + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in wallsm.items()) + f"  [{card}]")
    say(f"[mapped] launches over the mapped aggregation path: {launches}")
    for name in ("rb_expand_rows", "rb_popcount_rows"):
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on the mapped path")
    if launches["rb_group_reduce[dense]"] + launches["rb_group_reduce[rowmap]"] == 0:
        fail("rb_group_reduce was not launched on the mapped path")
    path_launches = dict(launches)

    # --- timing: the cold wide OR's stages on a fresh mapping, and medians ---
    view3 = _map_file(path)
    mapped3, _ = _map_bitmaps(view3, extents)
    store.PACK_CACHE.close()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_views = sum(len(list(m.high_low_container.containers)) for m in mapped3)
    t1 = time.perf_counter()
    groups = store.group_by_key(mapped3)
    t2 = time.perf_counter()
    packed = store.pack_groups(groups, "cuda")
    t3 = time.perf_counter()
    staged = packed._payload.materialize(pinned=True)
    t4 = time.perf_counter()
    shipped = K.ship_payload(K.payload_parts(packed.n_rows, *staged), "cuda")
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    K.expand_shipped(packed.n_rows, shipped)
    torch.cuda.synchronize()
    t6 = time.perf_counter()
    del staged, shipped
    flat = packed.device_words  # the same expansion, through the pack
    torch.cuda.synchronize()
    t7 = time.perf_counter()
    run, layout = store.prepare_reduce(packed, "or")
    red, cards = run()
    torch.cuda.synchronize()
    t8 = time.perf_counter()
    words_host, cards_host = dev.to_host_u32(red), cards.cpu().numpy().astype(np.int64)
    r = store.unpack_to_bitmap(packed.group_keys, words_host, cards_host)
    t9 = time.perf_counter()
    if r.serialize() != RoaringBitmap.deserialize(want_bytes["or_"]).serialize():
        fail("the staged mapped OR differs from the heap path's")
    say(f"[mapped] cold OR stages on a fresh mapping: view build {(t1 - t0) * 1e3:.1f} ms ({n_views} "
        f"container views, run payloads checked), group_by_key {(t2 - t1) * 1e3:.1f}, payload build "
        f"{(t3 - t2) * 1e3:.1f}, concatenate into pinned staging (page faults) {(t4 - t3) * 1e3:.1f}, "
        f"copy {(t5 - t4) * 1e3:.1f}, rb_expand_rows {(t6 - t5) * 1e3:.1f}, reduce ({layout}, row map) "
        f"{(t8 - t7) * 1e3:.1f}, result to the host + unpack {(t9 - t8) * 1e3:.1f}; {packed.n_rows} rows, "
        f"{packed._payload.nbytes} payload bytes  [{card}]")
    del flat, red, cards, packed, groups
    torch.cuda.empty_cache()
    cold, heap_cold = [], []
    for _ in range(MAPPED_RUNS):  # mapped and heap in turns
        for walls_, fn in ((cold, BufferFastAggregation.or_), (heap_cold, FastAggregation.or_)):
            store.PACK_CACHE.close()
            t0 = time.perf_counter()
            fn(*(mapped2 if walls_ is cold else heap), mode="device")
            walls_.append(time.perf_counter() - t0)
    med, med_heap, med_warm = float(np.median(cold)), float(np.median(heap_cold)), float(np.median(warm))
    say(f"[mapped] BufferFastAggregation.or_ end to end over the mapped bitmaps, {MAPPED_RUNS} runs: cold "
        f"median {med * 1e3:.2f} ms (min {min(cold) * 1e3:.2f}, max {max(cold) * 1e3:.2f}), "
        f"{1 / med:.3f} aggregations/s; the heap FastAggregation.or_ in turn: median "
        f"{med_heap * 1e3:.2f} ms; warm median {med_warm * 1e3:.2f} ms, {1 / med_warm:.3f} "
        f"aggregations/s  [{card}]")

    def cold_or():
        store.PACK_CACHE.close()
        return BufferFastAggregation.or_(*mapped2, mode="device")

    _profiled("[mapped]", "BufferFastAggregation.or_ cold", cold_or, card)
    BufferFastAggregation.or_(*mapped2, mode="device")
    _profiled("[mapped]", "BufferFastAggregation.or_ warm",
              lambda: BufferFastAggregation.or_(*mapped2, mode="device"), card)
    peak = torch.cuda.max_memory_allocated()
    say(f"[mapped] peak device memory {peak / 2**30:.2f} GiB ({peak} bytes)  [{card}]")
    _unaligned_entry_points(mapped2, card)

    # --- the skewed mix on the segmented layout, mapped ---
    rng = np.random.default_rng(SEED + 13)
    sizes = np.round(146 ** (np.arange(18) / 17)).astype(int)
    seg_vals = []
    for j in range(int(sizes.max())):
        seg_vals.append(np.concatenate([
            ((k << 16) + rng.choice(1 << 16, size=int(rng.integers(1, 5000)), replace=False)).astype(np.uint32)
            for k in range(18) if j < sizes[k]
        ]))
    seg_path = os.path.join(tmp.name, "skewed.bin")
    seg_extents = _write_blobs(seg_path, [RoaringBitmap(v).serialize() for v in seg_vals])
    seg_mapped, _ = _map_bitmaps(_map_file(seg_path), seg_extents)
    before = dict(store.LAYOUT_COUNTS)
    K.reset_launches()
    got = BufferFastAggregation.or_(*seg_mapped, mode="device")
    seg_launches = dict(K.LAUNCHES)
    if _layout_delta(store, before) != {"segmented-scan": 1}:
        fail(f"the mapped skewed set took layout {_layout_delta(store, before)}, expected segmented-scan")
    _check_values("mapped skewed set (18 groups, 1..146 rows) BufferFastAggregation.or_", got,
                  np.unique(np.concatenate(seg_vals)), "[mapped]")
    if seg_launches["rb_group_reduce[csr]"] + seg_launches["rb_group_reduce[rowmap]"] == 0:
        fail(f"the mapped skewed set did not reduce on rb_group_reduce: {seg_launches}")
    for k, v in seg_launches.items():
        path_launches[k] += v
    say(f"[mapped] skewed set: layout segmented-scan, launches {seg_launches}")
    store.PACK_CACHE.close()
    del mapped1, mapped3, seg_mapped, heap, mixed
    torch.cuda.empty_cache()

    # --- the mapped BSI: phase 6's index, serialized and mapped ---
    t0 = time.perf_counter()
    bsi_path = os.path.join(tmp.name, "bsi.bin")
    blob = index.serialize()
    with open(bsi_path, "wb") as f:
        f.write(blob)
    t_bsi_write = time.perf_counter() - t0
    med_v = int(np.median(vals))
    q_vals = np.quantile(vals, np.linspace(0.05, 0.95, BATCH_Q)).astype(np.int64)
    want_ge = index.compare(Operation.GE, med_v).serialize()
    want_many = index.compare_cardinality_many(Operation.GE, q_vals)
    del blob
    bview = _map_file(bsi_path)
    t0 = time.perf_counter()
    mbsi = ImmutableBitSliceIndex(bview)
    t_map = time.perf_counter() - t0
    K.reset_launches()
    t0 = time.perf_counter()
    first = mbsi.compare(Operation.GE, med_v)
    t_first = time.perf_counter() - t0
    if first.serialize() != want_ge:
        fail("the mapped BSI's first compare GE median differs from the heap index's")
    _check_values("mapped BSI compare GE median (first query from the fresh map)", first,
                  np.flatnonzero(vals >= med_v), "[mapped]")
    bw = []
    for _ in range(E2E_RUNS):
        t0 = time.perf_counter()
        got = mbsi.compare(Operation.GE, med_v)
        bw.append(time.perf_counter() - t0)
    if got.serialize() != want_ge:
        fail("the mapped BSI's steady compare differs from the heap index's")
    t0 = time.perf_counter()
    many = mbsi.compare_cardinality_many(Operation.GE, q_vals)
    t_many = time.perf_counter() - t0
    if not np.array_equal(many, want_many):
        fail("the mapped BSI's compare_cardinality_many differs from the heap index's")
    bsi_l = dict(K.LAUNCHES)
    if bsi_l["rb_oneil_compare"] == 0 or bsi_l["rb_oneil_compare[batched]"] != 1:
        fail(f"the mapped BSI did not run on rb_oneil_compare and one rb_oneil_counts: {bsi_l}")
    for k, v in bsi_l.items():
        path_launches[k] += v
    bsi_med = float(np.median(bw))
    say(f"[mapped] BSI serialized and written in {t_bsi_write:.2f} s ({os.path.getsize(bsi_path)} bytes), "
        f"mapped as ImmutableBitSliceIndex in {t_map * 1e3:.1f} ms; first compare GE median from the "
        f"fresh map {t_first * 1e3:.1f} ms (phase 6's heap index: {bsi_times['first_ms']:.1f}); steady "
        f"compare median {bsi_med * 1e3:.2f} ms over {E2E_RUNS} runs, {1 / bsi_med:.2f} queries/s "
        f"(phase 6: {bsi_times['compare_ms']:.2f}); compare_cardinality_many GE x{BATCH_Q} "
        f"{t_many * 1e3:.2f} ms, {t_many / BATCH_Q * 1e9:.0f} ns/query (phase 6: "
        f"{bsi_times['many_ns']:.0f}); every answer equal to the heap index's; launches {bsi_l}  [{card}]")
    del mbsi, first, got
    store.PACK_CACHE.close()
    torch.cuda.empty_cache()
    del mapped2
    tmp.cleanup()
    say(f"[mapped] phase 13 took {time.perf_counter() - t_phase:.1f} s  [{card}]")
    return path_launches


# ---------------------------------------------------------------------------
# phase 14: the 64-bit family
# ---------------------------------------------------------------------------

R64_BUCKETS = 4  # bitmap i of the census set lifted into high-32 bucket i // 2500
R64_COLD_RUNS, R64_WARM_RUNS = 5, 10
AGG64_BITMAPS = 64  # benchmarks/aggregation64.py:18-34
BSI64_ROWS = 100_000_000  # BASELINE.md config 4, at 64 bits
BSI64_BASE = 1 << 33  # the first column id: every id lies above 2^32
BSI64_VALUE_BITS = 48  # values uniform in [0, 2^48)
S_BSI64, K_BSI64 = BSI64_VALUE_BITS, (BSI64_ROWS + 65535) // 65536  # [48, 1526, 2048] slices
# the whole script builds phase 14 (b)'s index at this depth (its
# set_values is ~150 s of host time at 100M rows), keeping the script
# inside its time with phase 18 added; --only sixtyfour keeps 100M rows
WHOLE_BSI64_ROWS = 50_000_000


def _cut_bsi64(rows: int) -> None:
    global BSI64_ROWS, K_BSI64
    BSI64_ROWS, K_BSI64 = rows, (rows + 65535) // 65536


def _check64(tag, name, got, oracle):
    arr = got.to_array()
    if arr.shape != oracle.shape or not np.array_equal(arr, oracle.astype(np.uint64)):
        fail(f"{name}: result ({arr.size} values) differs from the oracle ({oracle.size})")
    say(f"{tag} {name}: {arr.size} values, equal to the oracle")


def _lift(b: int, values) -> np.ndarray:
    return (np.uint64(b) << np.uint64(32)) | np.asarray(values).astype(np.uint64)


def _agg64_benchmark_shape():
    """benchmarks/aggregation64.py's working set: 64 bitmaps over high-32
    buckets 0, 3-6 and 9 << 8, as (Roaring64Bitmaps, NavigableMaps, values)."""
    from roaringbitmap_tpu_torch import Roaring64Bitmap, Roaring64NavigableMap

    rng = np.random.default_rng(SEED)
    arts, navs, vals = [], [], []
    for i in range(AGG64_BITMAPS):
        v = np.concatenate([
            rng.integers(0, 1 << 20, size=20_000, dtype=np.uint64),
            (np.uint64(3 + (i % 4)) << np.uint64(32)) + rng.integers(0, 1 << 20, size=15_000, dtype=np.uint64),
            (np.uint64(9) << np.uint64(40)) + rng.integers(0, 1 << 18, size=5_000, dtype=np.uint64),
        ])
        vals.append(v)
        arts.append(Roaring64Bitmap(v))
        navs.append(Roaring64NavigableMap(v))
    return arts, navs, vals


def phase_aggregation64(base, card: str):
    """Phase 14 (a): the census working set lifted to 64 bits through
    ``FastAggregation64`` and ``or_navigable`` on the card, and the 64-bit
    benchmark's own shape. Returns the launch counts of the checked calls."""
    from roaringbitmap_tpu_torch import (
        FastAggregation,
        FastAggregation64,
        Roaring64Bitmap,
        Roaring64NavigableMap,
    )
    from roaringbitmap_tpu_torch.ops import device as dev
    from roaringbitmap_tpu_torch.ops import kernels as K
    from roaringbitmap_tpu_torch.parallel import aggregation, aggregation64, store

    if aggregation.config.device != "cuda":
        fail(f"aggregation.config.device is {aggregation.config.device!r}, expected 'cuda'")
    t_phase = time.perf_counter()
    store.PACK_CACHE.close()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    nb, per = len(base), N_BITMAPS // R64_BUCKETS
    lifted = [[_lift(b, v) for v in base] for b in range(R64_BUCKETS)]
    t0 = time.perf_counter()
    arts = [Roaring64Bitmap(lifted[i // per][i % nb]) for i in range(N_BITMAPS)]
    t1 = time.perf_counter()
    navs = [Roaring64NavigableMap(lifted[i // per][i % nb]) for i in range(N_BITMAPS)]
    t2 = time.perf_counter()
    del lifted
    n_cont = sum(a.get_high_to_bitmap_count() for a in arts)
    n_cont32 = sum(b.get_container_count() for m in navs for b in m._buckets.values())
    n_groups = len(aggregation64._group_by_key64(arts))
    quarters = [range(b * per, (b + 1) * per) for b in range(R64_BUCKETS)]
    keys32 = [len({k for i in q for k in navs[i]._buckets[b].high_low_container.keys})
              for b, q in enumerate(quarters)]
    if n_cont != n_cont32 or n_groups != sum(keys32):
        fail(f"the lifted set has {n_cont} containers in {n_groups} groups; its 32-bit buckets "
             f"{n_cont32} in {sum(keys32)}")
    say(f"[sixtyfour] census set lifted to 64 bits ({N_BITMAPS} bitmaps, bitmap i in high-32 bucket "
        f"i // {per}): {n_cont} containers in {n_groups} key groups, {n_cont * ROW_BYTES} bytes of "
        f"rows; built as Roaring64Bitmap in {t1 - t0:.1f} s and as Roaring64NavigableMap in "
        f"{t2 - t1:.1f} s (set-up)  [{card}]")

    # --- oracles: numpy, and the port's 32-bit path over each quarter ---
    want_or, want_xor = [], []
    for b, q in enumerate(quarters):
        mult = np.bincount([i % nb for i in q], minlength=nb)
        in_q = [base[j] for j in np.flatnonzero(mult)]
        odd = [base[j] for j in np.flatnonzero(mult % 2)]
        o_or = np.unique(np.concatenate(in_q)).astype(np.uint32)
        o_xor = _count_oracle(odd, len(odd))[1]
        q32 = [navs[i]._buckets[b] for i in q]
        _check64("[sixtyfour]", f"32-bit FastAggregation.or_ over quarter {b}",
                 FastAggregation.or_(*q32, mode="device"), o_or)
        _check64("[sixtyfour]", f"32-bit FastAggregation.xor over quarter {b}",
                 FastAggregation.xor(*q32, mode="device"), o_xor)
        want_or.append(_lift(b, o_or))
        want_xor.append(_lift(b, o_xor))
    want_or, want_xor = np.concatenate(want_or), np.concatenate(want_xor)
    store.PACK_CACHE.close()
    torch.cuda.empty_cache()

    # --- the 64-bit path, counts zeroed just before and read just after ---
    K.reset_launches()
    layouts = dict(store.LAYOUT_COUNTS)
    walls = {}
    t0 = time.perf_counter()
    r_or = FastAggregation64.or_(*arts, mode="device")
    walls["or_"] = time.perf_counter() - t0
    _check64("[sixtyfour]", f"FastAggregation64.or_ ({N_BITMAPS} bitmaps)", r_or, want_or)
    t0 = time.perf_counter()
    r_xor = FastAggregation64.xor(*arts, mode="device")
    walls["xor"] = time.perf_counter() - t0
    _check64("[sixtyfour]", f"FastAggregation64.xor ({N_BITMAPS} bitmaps)", r_xor, want_xor)
    t0 = time.perf_counter()
    card_or = FastAggregation64.or_cardinality(*arts, mode="device")
    walls["or_cardinality"] = time.perf_counter() - t0
    if card_or != want_or.size:
        fail(f"FastAggregation64.or_cardinality = {card_or}, oracle {want_or.size}")
    t0 = time.perf_counter()
    r_nav = aggregation64.or_navigable(*navs, mode="device")
    walls["or_navigable"] = time.perf_counter() - t0
    _check64("[sixtyfour]", f"or_navigable ({N_BITMAPS} maps)", r_nav, want_or)
    if r_nav.serialize() != r_or.serialize():
        fail("or_navigable and FastAggregation64.or_ serialize differently")
    census_launches = dict(K.LAUNCHES)
    census_layouts = {k: v - layouts[k] for k, v in store.LAYOUT_COUNTS.items() if v != layouts[k]}
    say(f"[sixtyfour] or_cardinality {card_or}, equal to the oracle; or_navigable's portable bytes "
        f"equal FastAggregation64.or_'s; first calls (ms): "
        + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in walls.items())
        + f"; layouts {census_layouts}; launches {census_launches}  [{card}]")
    or_bytes = r_or.serialize()
    del r_or, r_xor, r_nav

    # --- benchmarks/aggregation64.py's shape: correctness and one time ---
    b_arts, b_navs, b_vals = _agg64_benchmark_shape()
    b_union = np.unique(np.concatenate(b_vals))
    b_walls = {}
    for name, fn, oracle in (
        ("FastAggregation64.or_", lambda m: FastAggregation64.or_(*b_arts, mode=m), b_union),
        ("FastAggregation64.and_", lambda m: FastAggregation64.and_(*b_arts, mode=m), None),
        ("or_navigable", lambda m: aggregation64.or_navigable(*b_navs, mode=m), b_union),
    ):
        t0 = time.perf_counter()
        got = fn("device")
        b_walls[name] = time.perf_counter() - t0
        want = fn("cpu")
        if got.serialize() != want.serialize():
            fail(f"benchmark shape {name}: the device result differs from the CPU fold's bytes")
        if oracle is not None:
            _check64("[sixtyfour]", f"benchmark shape ({AGG64_BITMAPS} bitmaps) {name}", got, oracle)
    fold = b_arts[0].clone()
    for b_ in b_arts[1:]:
        fold.ior(b_)
    if fold.serialize() != FastAggregation64.or_(*b_arts, mode="cpu").serialize():
        fail("benchmark shape: the pairwise fold differs from FastAggregation64.or_")
    launches = dict(K.LAUNCHES)
    say(f"[sixtyfour] benchmark shape ({AGG64_BITMAPS} bitmaps, "
        f"{sum(a.get_high_to_bitmap_count() for a in b_arts)} containers): device equal to the CPU "
        f"fold's bytes and the pairwise fold; device calls (ms): "
        + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in b_walls.items()) + f"  [{card}]")
    for name in ("rb_expand_rows", "rb_popcount_rows"):
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on the 64-bit aggregation path")
    if sum(launches[k] for k in ("rb_group_reduce[dense]", "rb_group_reduce[rowmap]",
                                 "rb_group_reduce[csr]")) == 0:
        fail("rb_group_reduce was not launched on the 64-bit aggregation path")
    del b_arts, b_navs, b_vals

    # --- timing: the cold OR's stages, then medians ---
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    groups = aggregation64._group_by_key64(arts)
    t1 = time.perf_counter()
    packed = store.pack_groups(groups, "cuda")
    t2 = time.perf_counter()
    staged = packed._payload.materialize(pinned=True)
    t3 = time.perf_counter()
    shipped = K.ship_payload(K.payload_parts(packed.n_rows, *staged), "cuda")
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    K.expand_shipped(packed.n_rows, shipped)
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    del staged, shipped
    flat = packed.device_words  # the same expansion, through the pack
    torch.cuda.synchronize()
    t6 = time.perf_counter()
    run, layout = store.prepare_reduce(packed, "or")
    red, cards = run()
    torch.cuda.synchronize()
    t7 = time.perf_counter()
    words_host, cards_host = dev.to_host_u32(red), cards.cpu().numpy().astype(np.int64)
    t8 = time.perf_counter()
    out = Roaring64Bitmap()
    for key, c in store.iter_group_containers(packed.group_keys, words_host, cards_host):
        out._put(int(key).to_bytes(6, "big"), c)
    t9 = time.perf_counter()
    if out.serialize() != or_bytes:
        fail("the staged 64-bit OR differs from FastAggregation64.or_")
    say(f"[sixtyfour] cold FastAggregation64.or_ stages: _group_by_key64 {(t1 - t0) * 1e3:.1f} ms, "
        f"payload build {(t2 - t1) * 1e3:.1f}, concatenate into pinned staging {(t3 - t2) * 1e3:.1f}, "
        f"copy {(t4 - t3) * 1e3:.1f}, rb_expand_rows {(t5 - t4) * 1e3:.1f}, reduce ({layout}, row map) "
        f"{(t7 - t6) * 1e3:.1f}, result to the host {(t8 - t7) * 1e3:.1f}, rebuild ({len(packed.group_keys)} "
        f"containers into the trie) {(t9 - t8) * 1e3:.1f}; {packed.n_rows} rows, "
        f"{packed._payload.nbytes} payload bytes  [{card}]")
    del flat, red, cards, packed, groups, out
    torch.cuda.empty_cache()
    cold = {"FastAggregation64.or_": [], "or_navigable": []}
    calls = {"FastAggregation64.or_": lambda: FastAggregation64.or_(*arts, mode="device"),
             "or_navigable": lambda: aggregation64.or_navigable(*navs, mode="device")}
    for _ in range(R64_COLD_RUNS):  # the two entry points in turns
        for name, fn in calls.items():
            store.PACK_CACHE.close()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            fn()
            cold[name].append(time.perf_counter() - t0)
    warm = {name: [] for name in calls}
    for _ in range(R64_WARM_RUNS):
        for name, fn in calls.items():
            t0 = time.perf_counter()
            fn()
            warm[name].append(time.perf_counter() - t0)
    for name in calls:
        c_med, w_med = float(np.median(cold[name])), float(np.median(warm[name]))
        say(f"[sixtyfour] {name} end to end: cold (caches emptied before each) median "
            f"{c_med * 1e3:.2f} ms over {R64_COLD_RUNS} (min {min(cold[name]) * 1e3:.2f}, max "
            f"{max(cold[name]) * 1e3:.2f}), {1 / c_med:.3f} aggregations/s; warm median "
            f"{w_med * 1e3:.2f} ms over {R64_WARM_RUNS} (min {min(warm[name]) * 1e3:.2f}, max "
            f"{max(warm[name]) * 1e3:.2f}), {1 / w_med:.3f} aggregations/s  [{card}]")

    def cold_or():
        store.PACK_CACHE.close()
        return FastAggregation64.or_(*arts, mode="device")

    _profiled("[sixtyfour]", "FastAggregation64.or_ cold", cold_or, card)
    _profiled("[sixtyfour]", "FastAggregation64.or_ warm",
              lambda: FastAggregation64.or_(*arts, mode="device"), card)
    peak = torch.cuda.max_memory_allocated()
    say(f"[sixtyfour] peak device memory {peak / 2**30:.2f} GiB ({peak} bytes); phase 14 (a) took "
        f"{time.perf_counter() - t_phase:.1f} s  [{card}]")
    del arts, navs
    store.PACK_CACHE.close()
    torch.cuda.empty_cache()
    return launches


def phase_bsi64(card: str):
    """Phase 14 (b): the BSI north star at 64 bits through
    ``Roaring64BitmapSliceIndex``. Returns the launch counts of the
    checked queries, and the index with phase 15's batched query: ``(index,
    64 quantile thresholds, their GE counts from numpy)``."""
    from roaringbitmap_tpu_torch import Operation, Roaring64Bitmap, Roaring64BitmapSliceIndex
    from roaringbitmap_tpu_torch.models import bsi as tbsi
    from roaringbitmap_tpu_torch.models import bsi64 as tbsi64
    from roaringbitmap_tpu_torch.models.roaring64art import key_to_int
    from roaringbitmap_tpu_torch.ops import device as dev
    from roaringbitmap_tpu_torch.ops import kernels as K
    from roaringbitmap_tpu_torch.parallel import store

    if (tbsi.config.device, tbsi64.config.mode) != ("cuda", "auto"):
        fail(f"64-bit BSI config is {tbsi.config.device}/{tbsi64.config.mode}, expected cuda/auto")
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    cols = np.uint64(BSI64_BASE) + np.arange(BSI64_ROWS, dtype=np.uint64)
    vals = rng.integers(0, 1 << BSI64_VALUE_BITS, size=BSI64_ROWS, dtype=np.uint64)
    t1 = time.perf_counter()
    index = Roaring64BitmapSliceIndex()
    index.set_values((cols, vals))
    build_s = time.perf_counter() - t1
    say(f"[bsi64] built {BSI64_ROWS} rows (column ids {BSI64_BASE} + arange, values uniform in "
        f"[0, 2^{BSI64_VALUE_BITS}), seed {SEED:#x}; data {t1 - t0:.1f} s), {index.bit_count()} slices, "
        f"{index._key_count()} high-48 chunks through set_values in {build_s:.1f} s  [{card}]")
    if index.bit_count() != S_BSI64 or index._key_count() != K_BSI64:
        fail("the 64-bit index does not have the north star's shape")
    found_idx = np.sort(rng.choice(BSI64_ROWS, size=BSI64_ROWS // 20, replace=False))
    found = Roaring64Bitmap(cols[found_idx])
    # the ebm's last chunk past the last column and four chunks outside it
    outside = np.uint64(BSI64_BASE + BSI64_ROWS) + np.arange(0, 300_000, 7, dtype=np.uint64)
    found2 = Roaring64Bitmap(np.concatenate([cols[found_idx], outside]))
    srt = np.sort(vals)
    med = int(srt[BSI64_ROWS // 2])
    present = int(vals[12_345])
    lo, hi = med // 2, med + med // 2
    top = int(srt[-1000])  # near the max
    if top < 1 << (BSI64_VALUE_BITS - 1):
        fail(f"the predicate near the max ({top}) is below 2^{BSI64_VALUE_BITS - 1}")
    fv = vals[found_idx]
    q_vals = [int(srt[int(p * (BSI64_ROWS - 1))]) for p in np.linspace(0.05, 0.95, BATCH_Q)]
    want_many = BSI64_ROWS - np.searchsorted(srt, np.array(q_vals, dtype=np.uint64), side="left")
    del srt
    u = np.uint64
    queries = [
        ("GE median", Operation.GE, med, 0, None, lambda: cols[vals >= u(med)]),
        ("RANGE middle half", Operation.RANGE, lo, hi, None, lambda: cols[(vals >= u(lo)) & (vals <= u(hi))]),
        ("GE median, 5% found set", Operation.GE, med, 0, found, lambda: cols[found_idx[fv >= u(med)]]),
        ("EQ a present value", Operation.EQ, present, 0, None, lambda: cols[vals == u(present)]),
        ("NEQ a present value", Operation.NEQ, present, 0, None, lambda: cols[vals != u(present)]),
        ("GT median", Operation.GT, med, 0, None, lambda: cols[vals > u(med)]),
        ("LT median", Operation.LT, med, 0, None, lambda: cols[vals < u(med)]),
        ("LE median", Operation.LE, med, 0, None, lambda: cols[vals <= u(med)]),
        ("NEQ with a found set outside the ebm", Operation.NEQ, present, 0, found2,
         lambda: np.concatenate([cols[found_idx[fv != u(present)]], outside])),
        (f"GE near the max ({top} >= 2^{BSI64_VALUE_BITS - 1})", Operation.GE, top, 0, None,
         lambda: cols[vals >= u(top)]),
    ]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    # --- the 64-bit BSI path: every query below runs with the counts live ---
    t0 = time.perf_counter()
    first = index.compare(Operation.GE, med)
    t_first = time.perf_counter() - t0
    _check64("[bsi64]", "compare GE median (first query: pack + copy + kernel + rebuild)", first,
             queries[0][5]())
    del first
    for name, op, a, b, fs, oracle in queries:
        want = oracle()
        _check64("[bsi64]", f"compare {name}", index.compare(op, a, b, fs), want)
        cnt = index.compare_cardinality(op, a, b, fs)
        if cnt != want.size:
            fail(f"compare_cardinality {name} = {cnt}, oracle {want.size}")
        del want
    say(f"[bsi64] compare_cardinality of all {len(queries)} queries equal to the oracle")
    many = index.compare_cardinality_many(Operation.GE, q_vals)
    if not np.array_equal(many, want_many):
        fail(f"compare_cardinality_many GE over {BATCH_Q} quantiles differs from np.searchsorted")
    say(f"[bsi64] compare_cardinality_many GE over {BATCH_Q} quantile thresholds: equal to "
        f"np.searchsorted")
    launches = dict(K.LAUNCHES)
    say(f"[bsi64] launches over the 64-bit BSI path: {launches}")
    for name in ("rb_oneil_compare", "rb_oneil_compare[batched]"):
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on the 64-bit BSI path")
    if launches["rb_oneil_compare[batched]"] != 1 or launches["rb_oneil_compare[batched-deep]"]:
        fail(f"compare_cardinality_many did not take one tiled launch: {launches}")
    peak_queries = torch.cuda.max_memory_allocated()

    # --- timing on the resident pack ---
    keys, ebm_w, slices_w = index._pack_dense64()
    bits = _bits_tensor([[_pred_bits(med, S_BSI64)]])
    steady = cuda_ms(lambda: K.oneil_compare(slices_w, bits, ebm_w, ebm_w, "GE"))
    b_one = bound_ms(_oneil_bytes(S_BSI64, K_BSI64, 1, True, False))
    bits_q = _bits_tensor(_walks("GE", q_vals, S_BSI64))
    steady_many = cuda_ms(lambda: K.oneil_compare(slices_w, bits_q, ebm_w, ebm_w, "GE", True))
    clocks = smi_clocks()
    fields = clocks.split(",")
    mhz = _mhz(fields[1]) if len(fields) == 4 else 1980.0
    b_many, by, b_bytes, b_ops = batched_bound(S_BSI64, K_BSI64, BATCH_Q, True, mhz)
    say(f"[bsi64] steady kernels on the resident [{S_BSI64}, {K_BSI64}, 2048] pack: rb_oneil_compare GE "
        f"{steady:.4f} ms (bound {b_one:.4f} ms, {b_one / steady:.1%}); rb_oneil_counts GE x{BATCH_Q} "
        f"{steady_many:.4f} ms (byte bound {b_bytes:.4f}, operation bound {b_ops:.4f}: {by} bind, "
        f"{b_many / steady_many:.1%} of the bound); clocks.sm, clocks.max.sm, power.draw, "
        f"power.limit after: {clocks}  [{card}]")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _keys, out, cards = index._o_neil_device_walk(Operation.GE, med, None)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    words_host, cards_host = dev.to_host_u32(out), cards.cpu().numpy().astype(np.int64)
    t2 = time.perf_counter()
    key_ints = np.array([key_to_int(k) for k in _keys], dtype=np.int64)
    rebuilt = Roaring64Bitmap()
    held = rebuilt._containers
    rebuilt._art.bulk_load([
        (int(k).to_bytes(6, "big"), held.add(c))
        for k, c in store.iter_group_containers(key_ints, words_host, cards_host)
    ])
    t3 = time.perf_counter()
    say(f"[bsi64] compare GE stages: bits + launch + kernel {(t1 - t0) * 1e3:.3f} ms, result words "
        f"and cards to the host ({words_host.nbytes} bytes, pageable) {(t2 - t1) * 1e3:.3f} ms, "
        f"rebuild ({len(_keys)} containers into the trie) {(t3 - t2) * 1e3:.3f} ms  [{card}]")
    del out, cards, words_host, cards_host, rebuilt
    walls = []
    for _ in range(E2E_RUNS):
        t0 = time.perf_counter()
        index.compare(Operation.GE, med)  # returns a host bitmap: the work is done
        walls.append(time.perf_counter() - t0)
    e2e = float(np.median(walls))
    t0 = time.perf_counter()
    index.compare_cardinality_many(Operation.GE, q_vals)
    t_many = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    _profiled("[bsi64]", "compare GE median", lambda: index.compare(Operation.GE, med), card, 5)
    say(f"[bsi64] first query {t_first * 1e3:.1f} ms; compare GE end to end (resident pack to the "
        f"host Roaring64Bitmap), {E2E_RUNS} runs: median {e2e * 1e3:.2f} ms (min {min(walls) * 1e3:.2f}, "
        f"max {max(walls) * 1e3:.2f}), {1 / e2e:.2f} queries/s; compare_cardinality_many GE, "
        f"{BATCH_Q} thresholds in one launch: {t_many * 1e3:.2f} ms, {t_many / BATCH_Q * 1e9:.0f} "
        f"ns/query; peak device memory {peak / 2**30:.3f} GiB ({peak} bytes; {peak_queries} over "
        f"the checked queries); phase 14 (b) took {time.perf_counter() - t_phase:.1f} s  [{card}]")
    del keys, ebm_w, slices_w
    store.PACK_CACHE.close()
    torch.cuda.empty_cache()
    return launches, (index, q_vals, want_many)


def phase_sixtyfour(base, card: str):
    """Phase 14: the 64-bit family on the card; the launch counts of its
    checked calls (the kernels line's ``launches_64``) and phase 14 (b)'s
    index with its batched query, for phase 15."""
    launches = phase_aggregation64(base, card)
    launches_b, index64 = phase_bsi64(card)
    for k, v in launches_b.items():
        launches[k] += v
    say(f"[sixtyfour] launches over phase 14's path: {launches}")
    return launches, index64


# ---------------------------------------------------------------------------
# phase 3 (batch kernels) and phase 12: batch similarity
# ---------------------------------------------------------------------------

ANN_DOCS, ANN_QUERIES, ANN_TOP_K, ANN_DENSITY = 1_000_000, 64, 1000, 0.3  # filtered_ann.py:25-28
ANN_PAIRS_HALF = 24  # filtered_ann.py:85-103
ANN_RUNS, ANN_BLOCKS = 200, 5  # steady-state run(): blocks of calls, each block's median
FACET_SAMPLE = 500  # facet counts and results checked against the facade
PAIR_SAMPLE = 2_000  # all-pairs entries checked against and_cardinality
PAIR_OP_SAMPLE = 200  # or / xor / andnot entries checked against the facade
PAIRWISE_BLOCK = 200  # the census block of distinct bases held against the plain version
PAIR_REPS = 10  # kernel timing at the census scale
# the kernels line's shape for the all-pairs kernel: this many left rows
# against all the right rows, where the plain version runs whole in ~12 s
# (three 128-row tiles x 40 column tiles of 256: 120 CTAs, under one wave)
PAIRWISE_LINE_ROWS = 320
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core rate (NVIDIA data sheet)
# (n, m) pairs of the phase-3 check that straddle the kernel's 128 x 256
# tile, two more ragged shapes, and the key counts each runs at
PAIRWISE_EDGES = [(a, b) for a in (127, 128, 129) for b in (255, 256, 257)] + [(1, 1), (300, 77)]
PAIRWISE_KEYS = (1, 3, 31)
# all-ones [1, keys, 2048] pairs: 2^31 bits, one key past an s32 chunk of
# the kernel, and 2^32, across two chunk boundaries
ALL_ONES = ((1 << 15, 1 << 31), (1 << 16, 1 << 32))
# the tensor-core probe (csrc/mma_probe.cu): each form, its label and the
# bit pairs one CTA computes an iteration (an int8 MAC of 0/1 bytes is one)
PROBE_FORMS = (
    ("wgmma_s8", "wgmma int8 m64n256k32", 2 * 4 * 64 * 256 * 32),
    ("wgmma_b1", "wgmma b1 m64n256k256", 2 * 4 * 64 * 256 * 256),
    ("mma_b1", "mma.sync b1 m16n8k256", 16 * 4 * 16 * 8 * 256),
)
PROBE_MS = 50.0  # each form's timed launch lasts about this long
# the probe's rates in bit pairs a second (None: refused by ptxas), once measured
MMA_RATES: dict = {}


def mma_probe(card: str) -> dict:
    """Time each tensor-core form of ``csrc/mma_probe.cu`` on every SM (one
    launch of ~``PROBE_MS``, CUDA events) and print the rates in bit pairs
    a second on one line, with the operand form they choose for the
    all-pairs kernel: b1 ``wgmma`` if it assembles and runs at least 1.25x
    int8's rate, else int8."""
    from roaringbitmap_tpu_torch.ops import _build

    lib = _build.load()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    for form, label, per_iter in PROBE_FORMS:
        name = f"rb_mma_probe_{form}"
        if not hasattr(lib, name):
            MMA_RATES[form] = None
            continue
        fn = getattr(lib, name)
        out = torch.empty(sms * getattr(lib, f"{name}_threads")(), dtype=torch.int32, device="cuda")

        def run(iters):
            _build.check(lib, fn(0, sms, iters, out.data_ptr(), stream), name)

        run(16)
        _, ms = _event_ms(lambda: run(256))
        iters = max(256, int(256 * PROBE_MS / max(ms, 1e-3)))
        _, ms = _event_ms(lambda: run(iters))
        MMA_RATES[form] = sms * iters * per_iter / (ms / 1e3)
    s8, b1 = MMA_RATES["wgmma_s8"], MMA_RATES["wgmma_b1"]
    if s8 is None:
        fail(f"the int8 wgmma probe did not assemble: {_build.PROBE_REFUSED.get('wgmma_s8')}")
    chosen = "b1" if b1 is not None and b1 >= 1.25 * s8 else "int8"
    MMA_RATES["chosen"] = chosen
    say("[probe] tensor-core rates, bit pairs/s on all SMs: " + ", ".join(
        f"{label} " + (f"{MMA_RATES[form] / 1e12:.1f} T/s ({MMA_RATES[form] / s8:.2f}x int8)"
                       if MMA_RATES[form] is not None else "refused by ptxas")
        for form, label, _ in PROBE_FORMS)
        + f"; int8 data sheet {INT8_OPS_PER_S / 2 / 1e12:.1f} T MAC/s; chosen form: {chosen} "
        f"(rb_pairwise_and_card is built in the b1 form)  [{card}] [{smi_clocks()}]")
    for form, why in _build.PROBE_REFUSED.items():
        say(f"[probe] {form} refused: {why.splitlines()[0] if why else '(no message)'}")
    if chosen != "b1":
        say("[probe] on this card the probe's rule picks int8: the b1 kernel is held to the int8 bound")
    return dict(MMA_RATES)


def ann_workload():
    """BASELINE.md config 5 as ``benchmarks/filtered_ann.py:31-40`` builds
    it: a 1M-doc filter at density 0.3 and 64 top-1000 candidate sets."""
    from roaringbitmap_tpu_torch import RoaringBitmap

    rng = np.random.default_rng(SEED)
    docs = rng.choice(ANN_DOCS, size=int(ANN_DOCS * ANN_DENSITY), replace=False)
    doc_filter = RoaringBitmap(np.sort(docs).astype(np.uint32))
    queries = [
        np.sort(rng.choice(ANN_DOCS, size=ANN_TOP_K, replace=False)).astype(np.uint32)
        for _ in range(ANN_QUERIES)
    ]
    return doc_filter, [RoaringBitmap(q) for q in queries]


def facet_filter(base):
    """or(A) of phase 8: the union of the bases with index in [0, 67)."""
    from roaringbitmap_tpu_torch import RoaringBitmap

    lo, hi = Q1_THIRDS[0]
    return RoaringBitmap(np.unique(np.concatenate(base[lo:hi])).astype(np.uint32))


def _mask_bound_ms(q: int, k: int) -> float:
    """The masked count's least time: the batch and filter read once, the
    [Q, K] counts written once."""
    return bound_ms(q * k * ROW_BYTES + k * ROW_BYTES + q * k * 4)


def pairwise_bound(n: int, m: int, k: int):
    """(bound ms, "operations" or "bytes", byte ms, operation ms, int8 ms,
    what the operations are timed at) of the n x m AND-popcount matrix over
    K keys. Bytes: both sides read once, the int64 matrix written once.
    Operations: the n * m * K * 65536 bit pairs at the single-bit wgmma rate
    the probe measured where the b1 form was chosen and runs faster than
    int8's data-sheet rate (no data sheet gives a b1 rate), else as 0/1 int8
    products at 1,979 TOPS; the int8 time is returned either way."""
    b_bytes = bound_ms(4 * 2048 * k * (n + m) + 8 * n * m)
    pairs = n * m * k * 65536
    b_int8 = 2 * pairs / INT8_OPS_PER_S * 1e3
    b1 = MMA_RATES.get("wgmma_b1")
    if MMA_RATES.get("chosen") == "b1" and b1 > INT8_OPS_PER_S / 2:
        b_ops, at = pairs / b1 * 1e3, f"the measured b1 wgmma rate, {b1 / 1e12:.1f} T bit pairs/s"
    else:
        b_ops, at = b_int8, "the int8 data-sheet rate, 1,979 TOPS"
    return max(b_bytes, b_ops), "operations" if b_ops > b_bytes else "bytes", b_bytes, b_ops, b_int8, at


def phase_batch_kernels(card: str, base, bitmaps):
    """``rb_pair_rows`` counts-only against ``pair_rows_cardinality_plain``
    at config 5's batch and at the census batch (and, andnot; the rows mode
    too), timed at the census batch; the tensor-core probe
    (:func:`mma_probe`); ``rb_pairwise_and_card`` against
    ``pairwise_and_card_plain`` on shapes that straddle its 128 x 256 tile
    (K = 1, 3, 31) and on all-ones rows whose one pair holds 2^31 and 2^32
    bits. Bitwise equal."""
    from roaringbitmap_tpu_torch.ops import kernels as K
    from roaringbitmap_tpu_torch.parallel import batch

    out, errs = {}, []
    doc_filter, cands = ann_workload()
    cases = (("config 5", doc_filter, cands), ("census", facet_filter(base), bitmaps))
    for label, one, many in cases:
        filt, words, _ = batch._pack_one_vs_many(one, many, torch.device("cuda"))
        q, k, _w = words.shape
        ia, ib = batch._mask_streams(q, k, words.device)
        flat = words.view(q * k, 2048)
        for op in ("and", "andnot"):
            before = K.LAUNCHES["rb_pair_rows[counts]"]
            got = K.pair_rows_cardinality(flat, ia, filt, ib, op)
            torch.cuda.synchronize()
            if K.LAUNCHES["rb_pair_rows[counts]"] != before + 1:
                fail(f"rb_pair_rows[counts] {op}: no launch counted")
            want = K.pair_rows_cardinality_plain(flat, ia, filt, ib, op)
            errs.append(_compare(f"rb_pair_rows[counts] {label} {op}", got, want))
            total = int(want.long().sum())
            if not 0 < total < q * k * 65536:
                fail(f"rb_pair_rows[counts] {label} {op}: the plain answer has {total} bits")
            del got, want
        rows, cards = K.pair_rows_reduce(flat, ia, filt, ib, "and")
        want_rows, want_cards = K.pair_rows_reduce_plain(flat, ia, filt, ib, "and")
        _compare(f"rb_pair_rows rows mode {label} words", rows, want_rows)
        _compare(f"rb_pair_rows rows mode {label} cards", cards, want_cards)
        del rows, cards, want_rows, want_cards
        ms = cuda_ms(lambda: K.pair_rows_cardinality(flat, ia, filt, ib, "and"))
        plain = cuda_ms(lambda: K.pair_rows_cardinality_plain(flat, ia, filt, ib, "and"), reps=3, warmup=1)
        b = _mask_bound_ms(q, k)
        say(
            f"[kernel] rb_pair_rows[counts] {label} batch [{q}, {k}, 2048]: equal (and, andnot; rows "
            f"mode equal); {ms:.4f} ms, bound {b:.4f} ms ({b / ms:.1%} of bound), plain {plain:.3f} ms; "
            f"library call: none  [{card}]"
        )
        if label == "census":  # the shape of phase 12's facet counts
            out["rb_pair_rows[counts]"] = dict(
                replaces="roaringbitmap_tpu/parallel/batch.py:63", ms=ms, plain_ms=plain,
                bound_ms=b, bound_by="bytes",
            )
        del filt, words, flat, ia, ib
        torch.cuda.empty_cache()
    out["rb_pair_rows[counts]"]["max_abs_err"] = max(errs)

    mma_probe(card)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    perrs = []
    for n, m in PAIRWISE_EDGES:
        for k in PAIRWISE_KEYS:
            left = _rand_dense(gen, (n, k, 2048))
            right = _rand_dense(gen, (m, k, 2048)) & _rand_dense(gen, (m, k, 2048))
            before = K.LAUNCHES["rb_pairwise_and_card"]
            got = K.pairwise_and_card(left, right)
            torch.cuda.synchronize()
            if K.LAUNCHES["rb_pairwise_and_card"] != before + 1:
                fail("rb_pairwise_and_card: no launch counted")
            perrs.append(_compare(f"rb_pairwise_and_card [{n}, {k}] x [{m}, {k}]", got,
                                  K.pairwise_and_card_plain(left, right)))
    say(f"[kernel] rb_pairwise_and_card: equal on (n, m) = {PAIRWISE_EDGES} at K = {PAIRWISE_KEYS}  [{card}]")
    for keys, expect in ALL_ONES:
        ones = torch.full((1, keys, 2048), -1, dtype=torch.int32, device="cuda")
        got, ms = _event_ms(lambda: K.pairwise_and_card(ones, ones))
        perrs.append(_compare(f"rb_pairwise_and_card all-ones [1, {keys}, 2048]", got,
                              K.pairwise_and_card_plain(ones, ones)))
        if int(got.item()) != expect:
            fail(f"rb_pairwise_and_card all-ones [1, {keys}, 2048]: {int(got.item())}, expected {expect}")
        say(f"[kernel] rb_pairwise_and_card all-ones [1, {keys}, 2048]: {int(got.item())} = 2^"
            f"{expect.bit_length() - 1}, equal to the plain version; {ms:.1f} ms (one CTA)  [{card}]")
        del ones, got
        torch.cuda.empty_cache()
    out["rb_pairwise_and_card"] = dict(
        replaces="roaringbitmap_tpu/parallel/batch.py:184", max_abs_err=max(perrs),
        ms=None, plain_ms=None, bound_ms=None, bound_by="operations", library_ms=None,
    )
    return out


def _timed(fn):
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, (time.perf_counter() - t0) * 1e3


def _bits_int8(words: torch.Tensor) -> torch.Tensor:
    """int32 [s, 2048] words -> int8 [s, 65536] 0/1 bits. The shift is
    arithmetic on int32, so the bit is masked after it."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    return ((words.unsqueeze(-1) >> shifts) & 1).to(torch.int8).reshape(words.shape[0], -1)


def _int_mm_row(lw, rw, want, card: str):
    """The library row: per key, ``torch._int_mm`` of the [n, 65536] and
    [m, 65536] int8 bit matrices, summed in int64. Returns (matmul ms,
    expansion ms); fails if the sum is not the kernel's matrix."""
    n, k, _ = lw.shape
    m = rw.shape[0]
    acc = torch.zeros((n, m), dtype=torch.int64, device="cuda")
    mm_ms = exp_ms = 0.0
    torch._int_mm(_bits_int8(lw[:, 0].contiguous()), _bits_int8(rw[:, 0].contiguous()).t())  # warm-up
    for key in range(k):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        lb = _bits_int8(lw[:, key].contiguous())
        rb = _bits_int8(rw[:, key].contiguous())
        ev[1].record()
        part = torch._int_mm(lb, rb.t())
        ev[2].record()
        acc += part
        torch.cuda.synchronize()
        exp_ms += ev[0].elapsed_time(ev[1])
        mm_ms += ev[1].elapsed_time(ev[2])
        del lb, rb, part
    if not torch.equal(acc, want):
        fail("torch._int_mm over the bit matrices disagrees with rb_pairwise_and_card")
    say(f"[batch] library row: torch._int_mm over int8 0/1 bits, {k} keys of [{n}, 65536] x [65536, {m}]: "
        f"matmuls {mm_ms:.3f} ms, bit expansion {exp_ms:.3f} ms (apart); sum equal to the kernel's  [{card}]")
    del acc
    torch.cuda.empty_cache()
    return mm_ms, exp_ms


def _steady_blocks(run) -> str:
    """``ANN_BLOCKS`` blocks of ``ANN_RUNS`` back-to-back ``run()`` calls:
    the median over every call (ms and ns a query), and the least and
    greatest block median."""
    blocks = [[_timed(run)[1] for _ in range(ANN_RUNS)] for _ in range(ANN_BLOCKS)]
    med = float(np.median(np.concatenate(blocks)))
    per_block = [float(np.median(b)) for b in blocks]
    return (f"median of {ANN_BLOCKS} x {ANN_RUNS} calls {med:.4f} ms ({med * 1e6 / ANN_QUERIES:.1f} ns/query), "
            f"block medians {min(per_block):.4f}-{max(per_block):.4f} ms")


def _event_ms(fn):
    """(result, milliseconds) of one call of ``fn``, timed with CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    r = fn()
    stop.record()
    torch.cuda.synchronize()
    return r, start.elapsed_time(stop)


def phase_batch(base, card: str, n_left: int = N_BITMAPS):
    """Phase 12: batch similarity through the port's entry points. (a)
    filtered-ANN (config 5); (b) census facet counts over 10,000 bitmaps;
    (c) the census all-pairs matrix. Returns the launch counts of the
    entry-point calls (zeroed before each, timing and checks excluded) and
    the kernels line's numbers for the all-pairs kernel."""
    from roaringbitmap_tpu_torch import RoaringBitmap
    from roaringbitmap_tpu_torch.ops import kernels as K
    from roaringbitmap_tpu_torch.parallel import batch, store

    t_phase = time.perf_counter()
    store.PACK_CACHE.close()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(SEED + 12)
    nb = len(base)
    bitmaps = [RoaringBitmap(base[i % nb]) for i in range(N_BITMAPS)]
    cards = np.array([b.get_cardinality() for b in bitmaps], dtype=np.int64)
    path = {k: 0 for k in K.LAUNCHES}

    def on_path(fn):
        """Run an entry-point call with the counts zeroed just before it
        and read just after."""
        K.reset_launches()
        r = fn()
        torch.cuda.synchronize()
        for key, v in K.LAUNCHES.items():
            path[key] += v
        return r

    # (a) filtered-ANN, BASELINE.md config 5
    doc_filter, cands = ann_workload()
    keys = sorted({k for c in cands for k in c.high_low_container.keys})
    say(f"[batch] (a) config 5: filter {doc_filter.get_cardinality()} of {ANN_DOCS} docs, "
        f"{len(cands)} candidate sets of {ANN_TOP_K}, {len(keys)} keys: batch [{len(cands)}, {len(keys)}, 2048]")
    want_and = [RoaringBitmap.and_(c, doc_filter) for c in cands]
    want_andnot = [RoaringBitmap.andnot(c, doc_filter) for c in cands]
    got = on_path(lambda: batch.batched_cardinality(doc_filter, cands, "and"))
    if got.tolist() != [w.get_cardinality() for w in want_and]:
        fail("(a) batched_cardinality and differs from the per-query and_")
    got = on_path(lambda: batch.batched_cardinality(doc_filter, cands, "andnot"))
    if got.tolist() != [w.get_cardinality() for w in want_andnot]:
        fail("(a) batched_cardinality andnot differs from the per-query andnot")
    got = on_path(lambda: batch.batched_intersects(doc_filter, cands))
    if got.tolist() != [RoaringBitmap.intersects(c, doc_filter) for c in cands]:
        fail("(a) batched_intersects differs from intersects")
    for op, want in (("and", want_and), ("andnot", want_andnot)):
        res = on_path(lambda: batch.batched_op(doc_filter, cands, op))
        if res != want:
            fail(f"(a) batched_op {op} differs from the per-query facade")
    left, right = cands[:ANN_PAIRS_HALF], cands[ANN_PAIRS_HALF:2 * ANN_PAIRS_HALF]
    mat = on_path(lambda: batch.pairwise_and_cardinality(left, right))
    if mat.tolist() != [[RoaringBitmap.and_cardinality(a, b) for b in right] for a in left]:
        fail("(a) the 24 x 24 pairwise_and_cardinality differs from the and_cardinality loop")
    say("[batch] (a) batched_cardinality and / andnot, batched_intersects, batched_op and / andnot "
        "and the 24 x 24 overlap matrix: equal to the per-query facade")
    run = batch.prepare_batched_cardinality(doc_filter, cands)
    steady = _steady_blocks(run)
    calls = [_timed(lambda: batch.batched_cardinality(doc_filter, cands))[1] for _ in range(11)]
    facade = [_timed(lambda: [RoaringBitmap.and_(doc_filter, c) for c in cands])[1] for _ in range(5)]
    say(f"[batch] (a) steady run() {steady}; whole batched_cardinality median of 11 {np.median(calls):.3f} ms "
        f"({np.median(calls) * 1e6 / ANN_QUERIES:.1f} ns/query), per-query and_ loop {np.median(facade):.3f} ms  [{card}]")
    _profiled("[batch] (a)", "steady run()", run, card, calls=20)
    say(f"[batch] (a) steady run() again, after the profiler: {_steady_blocks(run)}  [{card}]")
    mw = [_timed(lambda: batch.pairwise_and_cardinality(left, right))[1] for _ in range(5)]
    say(f"[batch] (a) 24 x 24 matrix median {np.median(mw):.3f} ms ({np.median(mw) * 1e6 / 576:.1f} ns/pair)  [{card}]")
    del run

    # (b) census facet counts: or(A) against all 10,000 bitmaps
    filt = facet_filter(base)
    keys = sorted({k for c in bitmaps for k in c.high_low_container.keys})
    say(f"[batch] (b) facet filter or(A) {filt.get_cardinality()} values; {len(bitmaps)} bitmaps over "
        f"{len(keys)} keys: batch [{len(bitmaps)}, {len(keys)}, 2048]")
    fc, fwall = {}, {}
    for op in ("and", "andnot"):
        t0 = time.perf_counter()
        fc[op] = on_path(lambda: batch.batched_cardinality(filt, bitmaps, op))
        fwall[op] = (time.perf_counter() - t0) * 1e3
    ops, owall = _timed(lambda: on_path(lambda: batch.batched_op(filt, bitmaps, "and")))
    t0 = time.perf_counter()
    fwords, bwords, _ = batch._pack_one_vs_many(filt, bitmaps, torch.device("cuda"))
    torch.cuda.synchronize()
    pack_ms = (time.perf_counter() - t0) * 1e3
    q, k, _w = bwords.shape
    ia, ib = batch._mask_streams(q, k, bwords.device)
    for op in ("and", "andnot"):
        plain = K.pair_rows_cardinality_plain(bwords.view(q * k, 2048), ia, fwords, ib, op)
        plain = plain.view(q, k).cpu().numpy().astype(np.int64).sum(axis=1)
        if not np.array_equal(fc[op], plain):
            fail(f"(b) batched_cardinality {op} differs from the plain version in {int((fc[op] != plain).sum())} sets")
        ref = RoaringBitmap.and_ if op == "and" else RoaringBitmap.andnot
        for i in rng.choice(len(bitmaps), FACET_SAMPLE, replace=False).tolist():
            if fc[op][i] != ref(bitmaps[i], filt).get_cardinality():
                fail(f"(b) batched_cardinality {op} of bitmap {i} differs from the facade")
    if [r.get_cardinality() for r in ops] != fc["and"].tolist():
        fail("(b) batched_op and: result cardinalities differ from batched_cardinality")
    for i in rng.choice(len(bitmaps), FACET_SAMPLE, replace=False).tolist():
        if ops[i] != RoaringBitmap.and_(bitmaps[i], filt):
            fail(f"(b) batched_op and: bitmap {i} differs from the facade's and_")
    del ops
    step = batch._step("and", True)
    kern = cuda_ms(lambda: step(bwords, fwords), reps=5, warmup=1)
    counts_dev = step(bwords, fwords)
    torch.cuda.synchronize()  # the copy's time alone
    _, copy_ms = _timed(lambda: counts_dev.cpu())
    say(f"[batch] (b) equal: counts (and, andnot) for all {len(bitmaps)} against the plain version, "
        f"{FACET_SAMPLE} sampled against the facade; batched_op's {len(bitmaps)} cardinalities, "
        f"{FACET_SAMPLE} sampled results against and_")
    say(f"[batch] (b) walls: batched_cardinality and {fwall['and']:.1f} ms, andnot {fwall['andnot']:.1f} ms, "
        f"batched_op and {owall:.1f} ms; stages: pack {pack_ms:.1f} ms, mask streams + kernel {kern:.4f} ms, "
        f"copy {copy_ms:.3f} ms  [{card}]")
    _profiled("[batch] (b)", "batched_cardinality and", lambda: batch.batched_cardinality(filt, bitmaps), card)
    del fwords, bwords, ia, ib, counts_dev
    torch.cuda.empty_cache()

    # (c) census all-pairs, n_left x 10,000 over the shared keys
    lefts = bitmaps[:n_left]
    say(f"[batch] (c) all-pairs {len(lefts)} x {len(bitmaps)}")
    pc = dict(batch.PAIRWISE_COUNTS)
    inter, w_and = _timed(lambda: on_path(lambda: batch.pairwise_and_cardinality(lefts, bitmaps)))
    if batch.PAIRWISE_COUNTS["mxu"] != pc["mxu"] + 1:
        fail(f"(c) impl auto did not pick mxu on the card: {batch.PAIRWISE_COUNTS} from {pc}")
    jac, w_jac = _timed(lambda: on_path(lambda: batch.pairwise_jaccard(lefts, bitmaps)))
    derived, w_ops = {}, {}
    for op in ("or", "xor", "andnot"):
        derived[op], w_ops[op] = _timed(lambda: on_path(lambda: batch.pairwise_cardinality(lefts, bitmaps, op=op)))
    n, m = inter.shape
    if inter.shape != (len(lefts), len(bitmaps)) or inter.dtype != np.int64:
        fail(f"(c) matrix {inter.shape} {inter.dtype}")
    if not np.array_equal(np.diagonal(inter), cards[:n]):
        fail("(c) the diagonal differs from the cardinalities")
    if not np.array_equal(inter, inter[np.arange(n) % nb]) or not np.array_equal(inter, inter[:, np.arange(m) % nb]):
        fail("(c) equal bitmaps (copies of one base) have unequal rows or columns")
    for i, j in zip(rng.integers(0, n, PAIR_SAMPLE).tolist(), rng.integers(0, m, PAIR_SAMPLE).tolist()):
        if inter[i, j] != RoaringBitmap.and_cardinality(lefts[i], bitmaps[j]):
            fail(f"(c) entry ({i}, {j}) differs from and_cardinality")
    scalar = {"or": RoaringBitmap.or_cardinality, "xor": RoaringBitmap.xor_cardinality,
              "andnot": RoaringBitmap.andnot_cardinality}
    for i, j in zip(rng.integers(0, n, PAIR_OP_SAMPLE).tolist(), rng.integers(0, m, PAIR_OP_SAMPLE).tolist()):
        for op, fn in scalar.items():
            if derived[op][i, j] != fn(lefts[i], bitmaps[j]):
                fail(f"(c) pairwise_cardinality {op} entry ({i}, {j}) differs from the facade")
        u = scalar["or"](lefts[i], bitmaps[j])
        if jac[i, j] != (inter[i, j] / u if u else 0.0):
            fail(f"(c) jaccard entry ({i}, {j}) differs from and / or cardinality")

    t0 = time.perf_counter()
    run = batch.prepare_pairwise_mxu(lefts, bitmaps)
    torch.cuda.synchronize()
    pack_ms = (time.perf_counter() - t0) * 1e3
    lw, rw = run.device_tensors
    blk = min(PAIRWISE_BLOCK, n)
    plain_blk = K.pairwise_and_card_plain(lw[:blk].contiguous(), rw[:blk].contiguous())
    err = _compare("(c) rb_pairwise_and_card census block", K.pairwise_and_card(lw[:blk].contiguous(), rw[:blk].contiguous()), plain_blk)
    if not np.array_equal(inter[:blk, :blk], plain_blk.cpu().numpy()):
        fail(f"(c) the {blk} x {blk} block of distinct bases differs from the plain version")
    say(f"[batch] (c) equal: diagonal = cardinalities, equal rows and columns for equal bitmaps, the "
        f"{blk} x {blk} block of distinct bases = the plain version on the card, {PAIR_SAMPLE} sampled "
        f"entries = and_cardinality, {PAIR_OP_SAMPLE} sampled or / xor / andnot / jaccard entries = the facade")
    kms = cuda_ms(lambda: K.pairwise_and_card(lw, rw), reps=PAIR_REPS, warmup=1)
    dev_mat = K.pairwise_and_card(lw, rw)
    torch.cuda.synchronize()  # the copy's time alone
    host_mat, copy_ms = _timed(lambda: dev_mat.cpu().numpy())
    if not np.array_equal(host_mat, inter):
        fail("(c) the prepared run's matrix differs from pairwise_and_cardinality's")
    _, ie_ms = _timed(lambda: batch._inclusion_exclusion("or", inter, lefts, bitmaps))
    k_keys = lw.shape[1]
    b, by, b_bytes, b_ops, b_int8, at = pairwise_bound(n, m, k_keys)
    lib_full, _exp = _int_mm_row(lw, rw, dev_mat, card)
    del dev_mat, host_mat
    say(f"[kernel] rb_pairwise_and_card census [{n}, {k_keys}, 2048] x [{m}, {k_keys}, 2048]: {kms:.3f} ms "
        f"(mean of {PAIR_REPS}), bound {b:.3f} ms by {by} at {at} ({b / kms:.1%} of bound; bytes "
        f"{b_bytes:.3f} ms; int8 tensor cores {b_int8:.3f} ms, {b_int8 / kms:.1%}), "
        f"{n * m * k_keys * 65536 / kms / 1e9:.1f} T bit pairs/s; library torch._int_mm {lib_full:.3f} ms  "
        f"[{card}] [{smi_clocks()}]")
    # the kernels line: the kernel, its plain version and the library call,
    # each timed whole on the first rows of the left side against all m
    s = min(PAIRWISE_LINE_ROWS, n)
    ls = lw[:s].contiguous()
    s_ms = cuda_ms(lambda: K.pairwise_and_card(ls, rw))
    s_mat = K.pairwise_and_card(ls, rw)
    K.pairwise_and_card_plain(ls[:2].contiguous(), rw)  # warm-up
    s_plain, plain_ms = _event_ms(lambda: K.pairwise_and_card_plain(ls, rw))
    s_err = _compare(f"(c) rb_pairwise_and_card [{s}, {k_keys}, 2048] x [{m}, {k_keys}, 2048]", s_mat, s_plain)
    if not np.array_equal(inter[:s], s_plain.cpu().numpy()):
        fail(f"(c) the plain version's first {s} rows differ from pairwise_and_cardinality's")
    s_b, s_by, _, _, s_int8, _ = pairwise_bound(s, m, k_keys)
    lib_ms, exp_ms = _int_mm_row(ls, rw, s_mat, card)
    shape = f"[{s}, {k_keys}, 2048] x [{m}, {k_keys}, 2048]"
    say(f"[kernel] rb_pairwise_and_card {shape} (the kernels line's shape): {s_ms:.3f} ms (mean of {REPS}), "
        f"bound {s_b:.3f} ms by {s_by} ({s_b / s_ms:.1%}; int8 tensor cores {s_int8:.3f} ms); "
        f"plain {plain_ms:.1f} ms (one call, equal to the kernel and to the matrix's first {s} rows); "
        f"library torch._int_mm {lib_ms:.3f} ms (+ bit expansion {exp_ms:.3f} ms)  [{card}]")
    del s_mat, s_plain, ls
    say(f"[batch] (c) walls: pairwise_and_cardinality {w_and:.1f} ms, pairwise_jaccard {w_jac:.1f} ms, "
        + ", ".join(f"pairwise_cardinality {op} {w:.1f} ms" for op, w in w_ops.items())
        + f"; stages: pack both sides {pack_ms:.1f} ms, kernel {kms:.1f} ms, copy {copy_ms:.1f} ms, "
        f"inclusion-exclusion (or) {ie_ms:.1f} ms  [{card}]")
    del run, lw, rw, plain_blk
    torch.cuda.empty_cache()
    _profiled("[batch] (c)", "pairwise_and_cardinality", lambda: batch.pairwise_and_cardinality(lefts, bitmaps), card)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for key in ("rb_pair_rows[counts]", "rb_pairwise_and_card"):
        if path[key] == 0:
            fail(f"phase 12 ran no {key}")
    say("[batch] launches on the path: " + ", ".join(f"{k} {v}" for k, v in path.items() if v)
        + f"; peak device memory {peak:.2f} GiB; phase {time.perf_counter() - t_phase:.1f} s  [{card}]")
    return path, dict(ms=s_ms, plain_ms=plain_ms, bound_ms=s_b, bound_by=s_by, library_ms=lib_ms,
                      max_abs_err=max(err, s_err), shape=shape)


# ---------------------------------------------------------------------------
# phase 3 (c) and phase 15: row widths and the mesh
# ---------------------------------------------------------------------------

MESH_WIDTHS = (1024, 512)  # a rank's rows on a words axis of 2 and of 4
MESH_RUNS = 3  # turns of the sharded and the unsharded route per median
MESH_WORLD = 4  # gloo ranks sharing the card in phase 15 (b): mesh (2, 2)
MESH_TIMEOUT_S = 300  # a rank of phase 15 (b) still running then fails the phase
MESH_ONLY_ROWS = 10_000_000  # --only mesh: both BSI indexes cut to 10M rows
MESH_KERNELS = (
    "rb_group_reduce[dense]", "rb_popcount_rows", "rb_popcount_rows[masked]",
    "rb_oneil_compare", "rb_oneil_compare[batched]",
)


def phase_width_kernels(card: str):
    """Phase 3 (c): the four kernels that take a row width (``rb_group_reduce``
    dense, ``rb_popcount_rows`` plain and masked, ``rb_oneil_compare`` and
    ``rb_oneil_counts``) at the widths a mesh's words axis gives a rank, on
    a rank's blocks of the main paths' shapes (a 2-wide containers axis:
    ``[31, 5000, W]`` and ``[32, 763, W]``), bitwise against their plain
    versions; the W = 1024 rows of the kernels line, timed beside their
    bounds."""
    from roaringbitmap_tpu_torch.ops import kernels as K

    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    rng = np.random.default_rng(SEED + 15)
    mhz_max = max_sm_mhz()
    m, k, s_count = M_MAIN // 2, K_BSI // 2, S_BSI
    pred = 0x9E3779B9
    out = {}

    def row(name, shape, err, ms, plain, b, **kw):
        out[f"{name}@1024"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                                   shape=list(shape), **kw)

    for w in MESH_WIDTHS:
        rb = w * 4
        plan = K.SegmentPlan.dense(G_MAIN, m)
        for op in ("or", "and", "xor"):
            words = _rand_words(gen, G_MAIN * m * w, op, density=0.0044).view(G_MAIN * m, w)
            got = K.group_reduce(words, plan, op)
            err = _compare(f"rb_group_reduce[dense] {op} W={w}", got, K.group_reduce_plain(words, plan, op))
            line = f"[kernel] rb_group_reduce[dense] {op} [{G_MAIN}, {m}, {w}]: equal"
            if op == "or" and w == 1024:
                ms = cuda_ms(lambda: K.group_reduce(words, plan, op))
                plain = cuda_ms(lambda: K.group_reduce_plain(words, plan, op), reps=3, warmup=1)
                b = bound_ms(G_MAIN * m * rb + G_MAIN * rb)
                row("rb_group_reduce[dense]", (G_MAIN, m, w), err, ms, plain, b,
                    replaces="roaringbitmap_tpu/ops/pallas_kernels.py:397")
                line += f"; {ms:.4f} ms, bound {b:.4f} ms ({b / ms:.1%} of bound), plain {plain:.3f} ms"
            say(f"{line}  [{card}]")
        got = K.popcount_rows(words)
        _compare(f"rb_popcount_rows [{G_MAIN * m}, {w}]", got, K.popcount_rows_plain(words))
        red = K.group_reduce(words, plan, "xor")  # the path's shape: [G, W] reduced rows
        got = K.popcount_rows(red)
        err = _compare(f"rb_popcount_rows [{G_MAIN}, {w}]", got, K.popcount_rows_plain(red))
        line = f"[kernel] rb_popcount_rows [{G_MAIN * m}, {w}] and [{G_MAIN}, {w}]: equal"
        if w == 1024:
            ms = cuda_ms(lambda: K.popcount_rows(red))
            plain = cuda_ms(lambda: K.popcount_rows_plain(red), reps=3, warmup=1)
            b = bound_ms(G_MAIN * rb + G_MAIN * 4)
            row("rb_popcount_rows", (G_MAIN, w), err, ms, plain, b,
                replaces="roaringbitmap_tpu/ops/device.py:103")
            line += f"; [{G_MAIN}, {w}] {ms:.4f} ms, bound {b:.4f} ms ({b / ms:.1%} of bound), plain {plain:.3f} ms"
        say(f"{line}  [{card}]")
        del words, red

        ebm = torch.full((k, w), -1, dtype=torch.int32, device="cuda")
        slices = _near_slices(gen, pred, s_count, ebm, 5)
        found = _rand_dense(gen, (k, w)) & _rand_dense(gen, (k, w)) & ebm
        got = K.popcount_rows(slices, mask=found)
        err = _compare(f"rb_popcount_rows[masked] W={w}", got, K.popcount_rows_plain(slices, mask=found))
        line = f"[kernel] rb_popcount_rows[masked] [{s_count}, {k}, {w}] & [{k}, {w}]: equal"
        if w == 1024:
            ms = cuda_ms(lambda: K.popcount_rows(slices, mask=found))
            plain = cuda_ms(lambda: K.popcount_rows_plain(slices, mask=found), reps=3, warmup=1)
            b = bound_ms(s_count * k * rb + k * rb + s_count * k * 4)
            row("rb_popcount_rows[masked]", (s_count, k, w), err, ms, plain, b,
                replaces="roaringbitmap_tpu/models/bsi.py:1111")
            line += f"; {ms:.4f} ms, bound {b:.4f} ms ({b / ms:.1%} of bound), plain {plain:.3f} ms"
        say(f"{line}  [{card}]")
        lo, hi = pred - (1 << 16), pred + (1 << 16)
        for op in ONEIL_OPS:
            walks = [[_pred_bits(lo, s_count), _pred_bits(hi, s_count)]] if op == "RANGE" else [
                [_pred_bits(pred, s_count)]]
            r = _oneil_case(K, card, f"rb_oneil_compare {op} with a found set [{s_count}, {k}, {w}]",
                            slices, _bits_tensor(walks), ebm, found, op, False)
            if op == "GE" and w == 1024:
                row("rb_oneil_compare", (s_count, k, w), r["max_abs_err"], r["ms"], r["plain_ms"],
                    r["bound_ms"], replaces="roaringbitmap_tpu/ops/pallas_kernels.py:699")
        qs = _thresholds(rng, pred, BATCH_Q)
        for op in ONEIL_OPS:
            bits = _bits_tensor(_walks(op, qs, s_count))
            before = K.LAUNCHES["rb_oneil_compare[batched]"]
            got = K.oneil_compare(slices, bits, ebm, found, op, True)[1]
            torch.cuda.synchronize()
            if K.LAUNCHES["rb_oneil_compare[batched]"] != before + 1:
                fail(f"tiled walk {op} W={w}: launches {K.LAUNCHES}")
            want = K.oneil_compare_plain(slices, bits, ebm, found, op, True)[1]
            err = _compare(f"rb_oneil_compare[batched] {op} Q={BATCH_Q} W={w}", got, want)
            hits = int(want.long().sum())
            if not 0 < hits < BATCH_Q * int(K.popcount_rows(found).long().sum()):
                fail(f"tiled walk {op} W={w}: the plain answer has {hits} bits")
        plan_t = K.oneil_tile_plan(s_count, BATCH_Q, "GE", w)
        line = (f"[kernel] rb_oneil_compare[batched] Q={BATCH_Q} [{s_count}, {k}, {w}]: all 7 ops equal "
                f"with a found set ({plan_t.tile_words}-word tiles, {w // plan_t.tile_words} a chunk)")
        if w == 1024:
            bits = _bits_tensor(_walks("GE", qs, s_count))
            ms = cuda_ms(lambda: K.oneil_compare(slices, bits, ebm, ebm, "GE", True))
            plain = cuda_ms(lambda: K.oneil_compare_plain(slices, bits, ebm, ebm, "GE", True), reps=3, warmup=1)
            b, by, b_bytes, b_ops = batched_bound(s_count, k, BATCH_Q, True, mhz_max, w)
            row("rb_oneil_compare[batched]", (s_count, k, w), err, ms, plain, b, bound_by=by,
                replaces="roaringbitmap_tpu/models/bsi.py:974")
            line += (f"; GE without a found set {ms:.4f} ms, byte bound {b_bytes:.4f} ms, operation "
                     f"bound {b_ops:.4f} ms: {by} bind, {b / ms:.1%} of the bound; plain {plain:.3f} ms")
        say(f"{line}  [{card}]")
        del slices, found, ebm
        torch.cuda.empty_cache()
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _mesh_inputs():
    """Phase 15's program inputs, made on the card from the seed alike in
    every process: the census-shaped block ``[31, 10000, 2048]`` (sparse
    bits: a group's OR keeps about half of them), the north star's ``[32, 1526,
    2048]`` slices near a predicate with its ebm and a found set, and 64
    thresholds."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    # every bit set with probability 2^-14, by ANDs of random words (a
    # scatter of single bits would let duplicate indices land in another
    # order in each process): a group's OR over 10,000 rows keeps ~46%
    block = torch.empty((G_MAIN, M_MAIN, 2048), dtype=torch.int32, device="cuda")
    for g in range(G_MAIN):
        w = _rand_dense(gen, (M_MAIN, 2048))
        for _ in range(13):
            w &= _rand_dense(gen, (M_MAIN, 2048))
        block[g] = w
    ebm = torch.full((K_BSI, 2048), -1, dtype=torch.int32, device="cuda")
    ebm[K_BSI - 1, (BSI_ROWS - (K_BSI - 1) * 65536) // 32:] = 0
    pred = 0x9E3779B9
    slices = _near_slices(gen, pred, S_BSI, ebm, 5)
    found = _rand_dense(gen, ebm.shape) & _rand_dense(gen, ebm.shape) & ebm
    qs = _thresholds(np.random.default_rng(SEED + 16), pred, BATCH_Q)
    return block, slices, ebm, found, pred, qs


def _mesh_programs(sharding, mesh, inputs):
    """The five programs on this rank's blocks of ``inputs`` (consumed:
    the full tensors are dropped once cut), each result gathered on every
    rank. Returns (results as numpy, each program's wall in ms)."""
    block, slices, ebm, found, pred, qs = inputs
    inputs.clear()
    rows, chunked = ("containers", "words"), (None, "containers", "words")
    res, walls = {}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0) * 1e3
        return r

    from roaringbitmap_tpu_torch.ops.device import to_host_u32 as u32

    local = sharding.shard_rows(mesh, block, chunked)
    red, cards = timed("grouped_reduce or", lambda: sharding.distributed_grouped_reduce(mesh, "or")(local))
    res["grouped_or"] = u32(sharding.gather_shards(mesh, red, (None, "words")))
    res["grouped_or_cards"] = cards.cpu().numpy()
    del local
    local = sharding.shard_rows(mesh, block.view(-1, 2048), rows)
    del block
    total, card = timed("wide_or_cardinality", lambda: sharding.distributed_wide_or_cardinality(mesh)(local))
    res["wide_or"] = u32(sharding.gather_shards(mesh, total, ("words",)))
    res["wide_card"] = np.array([int(card)])
    del local
    torch.cuda.empty_cache()
    ls = sharding.shard_rows(mesh, slices, chunked)
    le, lf = sharding.shard_rows(mesh, ebm, rows), sharding.shard_rows(mesh, found, rows)
    del slices, ebm, found
    for op, bits in (("GE", _pred_bits(pred, S_BSI)),
                     ("RANGE", [_pred_bits(pred - (1 << 16), S_BSI), _pred_bits(pred + (1 << 16), S_BSI)])):
        out, c = timed(f"bsi_compare {op}", lambda: sharding.distributed_bsi_compare(mesh, op)(ls, bits, le, lf))
        res[f"compare_{op}"] = u32(sharding.gather_shards(mesh, out, rows))
        res[f"compare_{op}_cards"] = sharding.gather_shards(mesh, c, ("containers",)).cpu().numpy()
    counts = timed("bsi_sum", lambda: sharding.distributed_bsi_sum(mesh)(ls, lf))
    res["sum"] = sharding.gather_shards(mesh, counts, (None, "containers")).cpu().numpy()
    bits = [_pred_bits(q, S_BSI) for q in qs]
    cards = timed(f"bsi_counts_many GE Q={BATCH_Q}",
                  lambda: sharding.distributed_bsi_counts_many(mesh, "GE")(ls, bits, le, le))
    res["counts_many"] = sharding.gather_shards(mesh, cards, (None, "containers")).cpu().numpy()
    del ls, le, lf
    torch.cuda.empty_cache()
    return res, walls


def mesh_rank_main(rank: int, world: int, port: int, ref_dir: str) -> None:
    """One rank of phase 15 (b): a gloo world of ``world`` processes on
    ``cuda:0``, mesh (2, 2), so every kernel runs at W = 1024. The five
    programs on the seeded inputs and ``FastAggregation.or_`` through
    ``aggregation.config.mesh`` over the census set, each held to phase 15
    (a)'s answer in ``ref_dir``. Prints one JSON line; exits non-zero on a
    difference."""
    import torch.distributed as dist
    from pathlib import Path

    from roaringbitmap_tpu_torch import FastAggregation
    from roaringbitmap_tpu_torch.ops import kernels as K
    from roaringbitmap_tpu_torch.parallel import aggregation, sharding

    torch.cuda.set_device(0)
    sharding.initialize_multihost(
        f"tcp://127.0.0.1:{port}", world, rank, backend="gloo", timeout=MESH_TIMEOUT_S
    )
    mesh = sharding.make_mesh(world, words_axis=2)
    ref = np.load(Path(ref_dir) / "programs.npz")
    inputs = list(_mesh_inputs())
    K.reset_launches()
    got, walls = _mesh_programs(sharding, mesh, inputs)
    differ = [name for name in ref.files if not np.array_equal(got[name], ref[name])]
    _, bitmaps, _ = build_working_set()
    aggregation.config.mesh = mesh
    t0 = time.perf_counter()
    r = FastAggregation.or_(*bitmaps)
    torch.cuda.synchronize()
    walls["FastAggregation.or_ (cold)"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    r = FastAggregation.or_(*bitmaps)
    walls["FastAggregation.or_ (warm)"] = (time.perf_counter() - t0) * 1e3
    aggregation.config.mesh = None
    or_equal = r.serialize() == (Path(ref_dir) / "or.bin").read_bytes()
    print(json.dumps({
        "rank": rank, "mesh": mesh.mesh.tolist(), "coordinate": list(mesh.get_coordinate()),
        "backend": str(dist.get_backend()), "differ": differ, "or_equal": or_equal,
        "launches": dict(K.LAUNCHES), "walls_ms": walls,
    }), flush=True)
    dist.destroy_process_group()
    sys.exit(0 if not differ and or_equal else 1)


def _bsi_indexes_for_mesh(card: str):
    """``--only mesh``: the 32- and 64-bit north-star indexes built as
    phases 6 and 14 build them, cut to MESH_ONLY_ROWS rows."""
    from roaringbitmap_tpu_torch import Roaring64BitmapSliceIndex, RoaringBitmapSliceIndex

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    vals = rng.integers(0, 1 << 32, size=MESH_ONLY_ROWS, dtype=np.uint64).astype(np.int64)
    index = RoaringBitmapSliceIndex()
    index.set_values((np.arange(MESH_ONLY_ROWS, dtype=np.uint32), vals))
    rng = np.random.default_rng(SEED)
    cols = np.uint64(BSI64_BASE) + np.arange(MESH_ONLY_ROWS, dtype=np.uint64)
    vals64 = rng.integers(0, 1 << BSI64_VALUE_BITS, size=MESH_ONLY_ROWS, dtype=np.uint64)
    index64 = Roaring64BitmapSliceIndex()
    index64.set_values((cols, vals64))
    srt = np.sort(vals64)
    q64 = [int(srt[int(p * (MESH_ONLY_ROWS - 1))]) for p in np.linspace(0.05, 0.95, BATCH_Q)]
    want64 = MESH_ONLY_ROWS - np.searchsorted(srt, np.array(q64, dtype=np.uint64), side="left")
    say(f"[mesh] --only mesh: the 32- and 64-bit indexes cut to {MESH_ONLY_ROWS} rows "
        f"({index.ebm.get_container_count()} chunks), built in {time.perf_counter() - t0:.1f} s  [{card}]")
    return index, vals, (index64, q64, want64)


def _counts_ge(vals: np.ndarray, qs) -> np.ndarray:
    """How many of ``vals`` are >= each of the ascending thresholds
    ``qs``: one pass over the values."""
    qs = np.asarray(qs, dtype=np.int64)
    below = np.bincount(np.searchsorted(qs, vals, side="right"), minlength=len(qs) + 1)
    return vals.size - np.cumsum(below)[:-1]


def _turns(label: str, sharded, unsharded, card: str) -> None:
    """``MESH_RUNS`` walls of each route, taking turns; the medians."""
    walls = {"sharded": [], "unsharded": []}
    for _ in range(MESH_RUNS):
        for name, fn in (("sharded", sharded), ("unsharded", unsharded)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
    s, u = (float(np.median(walls[k])) for k in ("sharded", "unsharded"))
    say(f"[mesh] (a) {label}: sharded {s:.2f} ms, unsharded {u:.2f} ms, median of {MESH_RUNS} in turns "
        f"(sharded {', '.join(f'{x:.2f}' for x in walls['sharded'])}; unsharded "
        f"{', '.join(f'{x:.2f}' for x in walls['unsharded'])})  [{card}]")


def phase_mesh(base, index, vals, index64, card: str):
    """Phase 15: multi-device through ``parallel/sharding.py``. (a) an NCCL
    world of 1 on the card: the aggregation, planner, BSI and 64-bit BSI
    mesh routes at full size against the unsharded path and numpy, the
    five programs on full-size seeded inputs against the unsharded kernels,
    the routes timed in turns; (b) a gloo world of MESH_WORLD processes
    sharing the card, mesh (2, 2), every rank held to (a)'s answers.
    Returns (a)'s launch counts and (b)'s, summed over the ranks."""
    import tempfile
    import torch.distributed as dist
    from pathlib import Path

    from roaringbitmap_tpu_torch import FastAggregation, Operation, RoaringBitmap
    from roaringbitmap_tpu_torch import query as tq
    from roaringbitmap_tpu_torch.models import bsi as tbsi
    from roaringbitmap_tpu_torch.models import bsi64 as tbsi64
    from roaringbitmap_tpu_torch.ops import kernels as K
    from roaringbitmap_tpu_torch.ops.device import to_host_u32
    from roaringbitmap_tpu_torch.parallel import aggregation, sharding, store

    t_phase = time.perf_counter()
    _, bitmaps, _real = build_working_set()  # anew: phase 8's mutation stays out
    nb = len(base)
    oracle_or = np.unique(np.concatenate(base[: min(nb, N_BITMAPS)]))
    sub = bitmaps[:-1]
    mult = np.bincount(np.arange(len(sub)) % nb, minlength=nb)
    odd = [base[i] for i in np.flatnonzero(mult % 2)]
    oracle_xor = _count_oracle(odd, len(odd))[1]
    mult_all = np.bincount(np.arange(len(bitmaps)) % nb, minlength=nb)
    oracle_and = _count_oracle([base[i] for i in range(nb) if mult_all[i]], int((mult_all > 0).sum()))[0]
    A, B, C = ([b for i, b in enumerate(bitmaps) if lo <= i % nb < hi] for lo, hi in Q1_THIRDS)
    uA, uB, uC = (np.unique(np.concatenate(base[lo:hi])) for lo, hi in Q1_THIRDS)
    v, c = np.unique(np.concatenate([base[i % nb] for i in range(Q1_HEAD)]), return_counts=True)
    want_q1 = np.union1d(np.setdiff1d(np.intersect1d(uA, uB), uC), v[c >= 2])
    Q = tq.Q
    q1 = ((Q.or_(*A) & Q.or_(*B)) - Q.or_(*C)) | Q.threshold(2, *bitmaps[:Q1_HEAD])

    n_rows = vals.size
    rng = np.random.default_rng(SEED + 15)
    found_cols = np.sort(rng.choice(n_rows, size=n_rows // 20, replace=False))
    found = RoaringBitmap(found_cols.astype(np.uint32))
    med, present = int(np.median(vals)), int(vals[12_345])
    lo, hi = med // 2, med + med // 2
    fv = vals[found_cols]
    q_vals = np.quantile(vals, np.linspace(0.05, 0.95, BATCH_Q)).astype(np.int64)
    bsi_queries = [
        ("GE median", Operation.GE, med, 0, None, np.flatnonzero(vals >= med)),
        ("LT median", Operation.LT, med, 0, None, np.flatnonzero(vals < med)),
        ("EQ a present value", Operation.EQ, present, 0, None, np.flatnonzero(vals == present)),
        ("NEQ a present value", Operation.NEQ, present, 0, None, np.flatnonzero(vals != present)),
        ("RANGE middle half", Operation.RANGE, lo, hi, None, np.flatnonzero((vals >= lo) & (vals <= hi))),
        ("GE median, 5% found set", Operation.GE, med, 0, found, found_cols[fv >= med]),
    ]
    want_many = _counts_ge(vals, q_vals)
    index64_, q64, want64 = index64

    # the unsharded answers first, outside the counted run
    plain = {
        "or": FastAggregation.or_(*bitmaps), "and": FastAggregation.and_(*bitmaps),
        "xor": FastAggregation.xor(*sub), "q1": tq.execute(q1, cache=None),
        "bsi": [index.compare(op, a, b, fs) for _, op, a, b, fs, _ in bsi_queries],
        "sum": index.sum(found), "many": index.compare_cardinality_many(Operation.GE, q_vals),
        "many64": index64_.compare_cardinality_many(Operation.GE, q64),
    }
    inputs = list(_mesh_inputs())
    block, slices, ebm, fnd, pred, qs = inputs
    kernel_ref = {
        "grouped_or": K.group_reduce(block, K.SegmentPlan.dense(G_MAIN, M_MAIN), "or"),
        "wide_or": K.wide_reduce_cardinality(block.view(-1, 2048))[0],
        "compare_GE": K.oneil_compare(slices, _bits_tensor([[_pred_bits(pred, S_BSI)]]), ebm, fnd, "GE")[0],
        "sum": K.popcount_rows(slices, mask=fnd).view(S_BSI, K_BSI),
        "counts_many": K.oneil_compare(
            slices, _bits_tensor([[_pred_bits(q, S_BSI)] for q in qs]), ebm, ebm, "GE", True)[1],
    }
    del block, slices, ebm, fnd

    world = sharding.initialize_multihost(backend="nccl")
    mesh = sharding.make_mesh()
    say(f"[mesh] (a) world of {world} over a local store, backend {dist.get_backend()}, mesh "
        f"{mesh.mesh.tolist()} {mesh.mesh_dim_names} on {sharding.mesh_device(mesh)}  [{card}]")
    store.PACK_CACHE.close()
    torch.cuda.synchronize()
    K.reset_launches()
    # --- phase 15's path: every mesh-routed call below runs with the counts live ---
    aggregation.config.mesh = tbsi.config.mesh = tbsi64.config.mesh = mesh
    try:
        got = {
            "or": FastAggregation.or_(*bitmaps), "and": FastAggregation.and_(*bitmaps),
            "xor": FastAggregation.xor(*sub),
            "or_card": FastAggregation.or_cardinality(*bitmaps),
            "and_card": FastAggregation.and_cardinality(*bitmaps),
            "xor_card": FastAggregation.xor_cardinality(*sub),
        }
        engines = {st.engine for st in tq.plan(q1).steps}
        got["q1"] = tq.execute(q1, cache=None)
        got["bsi"] = [index.compare(op, a, b, fs) for _, op, a, b, fs, _ in bsi_queries]
        got["bsi_card"] = [index.compare_cardinality(op, a, b, fs) for _, op, a, b, fs, _ in bsi_queries]
        got["sum"] = index.sum(found)
        got["many"] = index.compare_cardinality_many(Operation.GE, q_vals)
        got["many64"] = index64_.compare_cardinality_many(Operation.GE, q64)
        programs, walls_a = _mesh_programs(sharding, mesh, inputs)
        torch.cuda.synchronize()
    finally:
        aggregation.config.mesh = tbsi.config.mesh = tbsi64.config.mesh = None
    launches = dict(K.LAUNCHES)
    say(f"[mesh] (a) launches over phase 15's path: {launches}")
    for name in MESH_KERNELS:
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on phase 15's path")

    for name, oracle in (("or", oracle_or), ("and", oracle_and), ("xor", oracle_xor)):
        if got[name] != plain[name]:
            fail(f"sharded FastAggregation {name} differs from the unsharded path")
        _check(f"(a) sharded FastAggregation.{name} (equal to the unsharded path)", got[name], oracle, "[mesh]")
        if got[f"{name}_card"] != oracle.size:
            fail(f"sharded {name}_cardinality = {got[f'{name}_card']}, oracle {oracle.size}")
    say(f"[mesh] (a) the three cardinalities equal the oracles: {got['or_card']}, {got['and_card']}, "
        f"{got['xor_card']}  [{card}]")
    if "device-or-sharded" not in engines:
        fail(f"Q1's plan under the mesh has engines {sorted(engines)}, not device-or-sharded")
    if got["q1"] != plain["q1"]:
        fail("Q1 through the sharded engines differs from the unsharded plan")
    _check(f"(a) Q1 through the planner, engines {sorted(engines)}", got["q1"], want_q1, "[mesh]")
    for (name, _op, _a, _b, _fs, oracle), g, p, cnt in zip(bsi_queries, got["bsi"], plain["bsi"], got["bsi_card"]):
        if g != p:
            fail(f"sharded BSI compare {name} differs from the unsharded path")
        _check_values(f"(a) sharded compare {name} (equal to the unsharded path)", g, oracle, "[mesh]")
        if cnt != oracle.size:
            fail(f"sharded compare_cardinality {name} = {cnt}, oracle {oracle.size}")
    if got["sum"] != plain["sum"] or got["sum"] != (int(fv.sum()), found_cols.size):
        fail(f"sharded sum {got['sum']}, unsharded {plain['sum']}, oracle {(int(fv.sum()), found_cols.size)}")
    if not (np.array_equal(got["many"], plain["many"]) and np.array_equal(got["many"], want_many)):
        fail("sharded compare_cardinality_many differs from the unsharded path or the oracle")
    if not (np.array_equal(got["many64"], plain["many64"]) and np.array_equal(got["many64"], want64)):
        fail("sharded 64-bit compare_cardinality_many differs from the unsharded path or the oracle")
    say(f"[mesh] (a) BSI compare_cardinality, sum {got['sum'][0]} and both batched counts over "
        f"{BATCH_Q} thresholds: equal to the unsharded path and the oracles  [{card}]")
    for name, want in kernel_ref.items():
        if not np.array_equal(programs[name], to_host_u32(want)):
            fail(f"program {name} on the world of 1 differs from the unsharded kernel")
    say(f"[mesh] (a) the five programs on full-size seeded inputs ([31, 10000, 2048]; [32, 1526, 2048], "
        f"Q = {BATCH_Q}): equal to the unsharded kernels where one computes the same; walls "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in walls_a.items()) + f"  [{card}]")
    del kernel_ref

    aggregation.config.mesh = tbsi.config.mesh = tbsi64.config.mesh = mesh
    routes = [
        ("FastAggregation.or_ (warm, resident pack)", lambda: FastAggregation.or_(*bitmaps)),
        ("Q1 through the planner (cache=None)", lambda: tq.execute(q1, cache=None)),
        ("BSI compare GE median", lambda: index.compare(Operation.GE, med)),
        ("BSI sum(found)", lambda: index.sum(found)),
        (f"BSI compare_cardinality_many GE Q={BATCH_Q}",
         lambda: index.compare_cardinality_many(Operation.GE, q_vals)),
        (f"64-bit compare_cardinality_many GE Q={BATCH_Q}",
         lambda: index64_.compare_cardinality_many(Operation.GE, q64)),
    ]
    cfgs = (aggregation.config, tbsi.config, tbsi64.config)

    def unsharded(fn):
        def run():
            for c in cfgs:
                c.mesh = None
            try:
                fn()
            finally:
                for c in cfgs:
                    c.mesh = mesh
        return run

    try:
        for label, fn in routes:
            _turns(label, fn, unsharded(fn), card)
        _profiled("[mesh]", "(a) sharded FastAggregation.or_ (warm)", routes[0][1], card, 3)
        _profiled("[mesh]", "(a) sharded BSI compare GE median", routes[2][1], card, 3)
    finally:
        for c in cfgs:
            c.mesh = None
    # the programs cached for this mesh die with its process group
    for program in (sharding.distributed_wide_or_cardinality, sharding.distributed_grouped_reduce,
                    sharding.distributed_bsi_compare, sharding.distributed_bsi_sum,
                    sharding.distributed_bsi_counts_many):
        program.cache_clear()
    dist.destroy_process_group()

    # (b): the gloo world sharing the card, held to (a)'s answers
    del got, plain
    store.PACK_CACHE.close()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as ref_dir:
        np.savez(Path(ref_dir) / "programs.npz", **programs)
        (Path(ref_dir) / "or.bin").write_bytes(FastAggregation.or_(*bitmaps).serialize())
        store.PACK_CACHE.close()
        torch.cuda.empty_cache()
        port = _free_port()
        t0 = time.perf_counter()
        procs = [
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r),
                 "--mesh-world", str(MESH_WORLD),
                 "--mesh-port", str(port), "--mesh-ref", ref_dir],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for r in range(MESH_WORLD)
        ]
        outs = [""] * MESH_WORLD
        try:
            for r, p in enumerate(procs):
                left = MESH_TIMEOUT_S - (time.perf_counter() - t0)
                outs[r], _ = p.communicate(timeout=max(left, 1))
        except subprocess.TimeoutExpired:
            fail(f"phase 15 (b): a rank of the gloo world was still running after {MESH_TIMEOUT_S} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    wall_b = time.perf_counter() - t0
    reports = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        if p.returncode != 0 or not lines:
            fail(f"phase 15 (b): rank {r} exited {p.returncode}:\n{out[-3000:]}")
        reports.append(json.loads(lines[-1]))
    launches_b = {k: sum(rep["launches"][k] for rep in reports) for k in K.LAUNCHES}
    for name in MESH_KERNELS:
        if launches_b[name] == 0:
            fail(f"kernel {name} was not launched on phase 15 (b)'s path")
    walls = reports[0]["walls_ms"]
    say(f"[mesh] (b) gloo world of {MESH_WORLD} processes sharing cuda:0, mesh {reports[0]['mesh']} "
        f"(containers, words), backend {reports[0]['backend']}: every rank's kernels ran at W = 1024 "
        f"on the card; gloo carries the collectives through host memory here, so each partial is "
        f"copied to the CPU for its collective and back; the five programs and the sharded "
        f"FastAggregation.or_ on every rank equal (a)'s answers; rank 0's walls "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in walls.items())
        + f"; launches summed over the ranks {launches_b}; (b) took {wall_b:.1f} s  [{card}]")
    say(f"[mesh] phase 15 took {time.perf_counter() - t_phase:.1f} s  [{card}]")
    return launches, launches_b




# ---------------------------------------------------------------------------
# phase 16: the observability and fault model on the main path
# ---------------------------------------------------------------------------

OBSERVE_RUNS = 10  # warm wide ORs per timeline mode, the modes in turns
OBSERVE_COLD_RUNS = 10  # cold wide ORs per mode (off, on), in turns
# the kernels of the census wide OR and Q1: phase 16 fails if one of them
# has no launch under the instrumentation
OBSERVE_KERNELS = ("rb_popcount_rows", "rb_expand_rows", "rb_threshold")


def _trace_busy(chrome: dict, calls: int):
    """Device busy µs per call in a ``tracing.trace`` window's Chrome
    trace: the union of its kernel, copy and memset intervals (the
    ``gpu_user_annotation`` ranges that ``record_function`` projects onto
    the device are not work, and are left out), and each kernel's µs per
    call by name."""
    spans, kernels = [], {}
    for e in chrome["traceEvents"]:
        if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        spans.append((e["ts"], e["ts"] + e["dur"]))
        if e["cat"] == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0.0) + e["dur"] / calls
    busy, end = 0.0, None
    for t0, t1 in sorted(spans):
        if end is None or t0 > end:
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
    return busy / calls, kernels


def phase_observe(base, bitmaps, real, card: str):
    """Phase 16: the census wide OR and Q1 with the timeline off, on and
    fenced (bytes, decisions, outcomes, counters, the Chrome trace), the
    timeline's overhead in turns, a ``tracing.trace`` window with its idle
    share, and faults on the card. Returns the launch counts of (a)."""
    import tempfile

    from roaringbitmap_tpu_torch import FastAggregation, insights, observe, tracing
    from roaringbitmap_tpu_torch import query as tq
    from roaringbitmap_tpu_torch import robust
    from roaringbitmap_tpu_torch.observe import compilewatch, decisions, outcomes
    from roaringbitmap_tpu_torch.observe import timeline as tl
    from roaringbitmap_tpu_torch.ops import kernels as K
    from roaringbitmap_tpu_torch.parallel import store
    from roaringbitmap_tpu_torch.robust import errors, faults

    t_phase = time.perf_counter()
    oracle_or = np.unique(np.concatenate(base[:min(len(base), len(bitmaps))]))
    q1, want_q1, _sets, _parts = _q1_setup(base, bitmaps, real)

    def or_():
        return FastAggregation.or_(*bitmaps)

    def q1_():
        return tq.execute(q1, cache=None)

    # the timeline off: the reference bytes
    tl.configure(mode="off")
    store.PACK_CACHE.close()
    ref_or = or_()
    _check("(a) FastAggregation.or_, timeline off", ref_or, oracle_or, "[observe]")
    ref_q1 = q1_()
    _check_values("(a) Q1, timeline off", ref_q1, want_q1, "[observe]")
    ref = (ref_or.serialize(), ref_q1.serialize())
    torch.cuda.synchronize()

    def cuda_dispatch():
        snap = observe.snapshot()[observe.KERNEL_DISPATCH_TOTAL]["samples"]
        return {s["labels"]["kind"]: s["value"] for s in snap if s["labels"]["engine"] == "cuda"}

    # --- phase 16's path: the on and fenced runs below, counts live ---
    builds = compilewatch.compile_counts()
    K.reset_launches()
    dispatch0 = cuda_dispatch()
    for mode in ("on", "fenced"):
        tl.configure(mode=mode)
        tl.RECORDER.clear()
        decisions.LOG.clear()
        outcomes.reset()
        store.PACK_CACHE.close()
        t0 = time.perf_counter()
        got = {"cold OR": or_(), "warm OR": or_(), "Q1": q1_()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for label, r in got.items():
            want = ref[1] if label == "Q1" else ref[0]
            if r.serialize() != want:
                fail(f"(a) {label} with the timeline {mode} differs from the timeline-off bytes")
        _check(f"(a) FastAggregation.or_ warm, timeline {mode} (bytes equal to off)", got["warm OR"],
               oracle_or, "[observe]")
        _check_values(f"(a) Q1, timeline {mode} (bytes equal to off)", got["Q1"], want_q1, "[observe]")
        dispatch = [e for e in decisions.decisions() if e["site"] == "agg.dispatch"]
        joined = [e for e in outcomes.tail() if e["site"] == "agg.dispatch"]
        if not dispatch or {e["decision"] for e in dispatch} != {"device"}:
            fail(f"(a) timeline {mode}: agg.dispatch decisions {[e['decision'] for e in dispatch]}, "
                 "expected device")
        if len(joined) != len(dispatch) or any(e["engine"] != "device" or not e["measured_s"] > 0
                                               for e in joined):
            fail(f"(a) timeline {mode}: {len(joined)} agg.dispatch outcomes for {len(dispatch)} "
                 f"decisions, or one not resolved on the device with a wall: {joined[:2]}")
        events = tl.RECORDER.events()
        names = {e.name for e in events}
        need = {"agg.device", "ladder.attempt", "pack.ship", "pack.device_expand",
                "store.reduce.padded", "query.step", "decision.agg.dispatch"}
        if not need <= names:
            fail(f"(a) timeline {mode}: the recorder lacks {sorted(need - names)}")
        with tempfile.TemporaryDirectory(prefix="rb_timeline_") as d:
            path = os.path.join(d, "timeline.json")
            tl.write_chrome_trace(path)
            trace = json.loads(open(path).read())
        n_spans = sum(e["ph"] == "X" for e in trace["traceEvents"])
        walls = {e["name"]: e["dur"] / 1e3 for e in trace["traceEvents"]
                 if e["ph"] == "X" and e["name"] in ("agg.device", "query.execute")}
        say(f"[observe] (a) timeline {mode}: cold OR, warm OR, Q1 in {wall * 1e3:.1f} ms; "
            f"{len(dispatch)} agg.dispatch decisions, each resolved on the device (walls "
            + ", ".join(f"{e['measured_s'] * 1e3:.2f}" for e in joined) + " ms); "
            f"{len(events)} recorder events; the Chrome trace parses ({len(trace['traceEvents'])} "
            f"events, {n_spans} spans; last agg.device / query.execute "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in walls.items()) + f")  [{card}]")
    tl.configure(mode="off")
    tl.RECORDER.clear()
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    dispatch1 = cuda_dispatch()
    delta = {k: dispatch1.get(k, 0) - dispatch0.get(k, 0) for k in launches}
    say(f"[observe] (a) launches over phase 16's path: {launches}; rb_tpu_kernel_dispatch_total"
        f"{{engine=cuda}} deltas {delta}  [{card}]")
    if delta != launches:
        fail("(a) the registry's dispatch deltas differ from LAUNCHES")
    if not (launches["rb_group_reduce[dense]"] + launches["rb_group_reduce[rowmap]"]):
        fail("(a) rb_group_reduce was not launched on phase 16's path")
    for name in OBSERVE_KERNELS:
        if not launches[name]:
            fail(f"(a) kernel {name} was not launched on phase 16's path")
    if compilewatch.compile_counts() != builds:
        fail(f"(a) rb_tpu_compile_total moved over the warm window: {builds} -> "
             f"{compilewatch.compile_counts()}")
    say(f"[observe] (a) rb_tpu_compile_total unchanged over the window: {builds}; "
        f"insights.pack_cache_counters() hits {insights.pack_cache_counters()['hits']}")

    # (b) overhead: warm OR, the modes in turns; cold OR off against on
    FastAggregation.or_(*bitmaps)  # resident, padded block built
    warm = {m: [] for m in ("off", "on", "fenced")}
    for _ in range(OBSERVE_RUNS):
        for m in warm:
            tl.configure(mode=m)
            t0 = time.perf_counter()
            or_()
            warm[m].append(time.perf_counter() - t0)
            tl.RECORDER.clear()
    cold = {m: [] for m in ("off", "on")}
    for _ in range(OBSERVE_COLD_RUNS):
        for m in cold:
            tl.configure(mode=m)
            store.PACK_CACHE.close()
            t0 = time.perf_counter()
            or_()
            cold[m].append(time.perf_counter() - t0)
            tl.RECORDER.clear()
    tl.configure(mode="off")
    for label, runs in (("warm", warm), ("cold", cold)):
        meds = {m: float(np.median(w)) * 1e3 for m, w in runs.items()}
        say(f"[observe] (b) FastAggregation.or_ {label}, {len(runs['off'])} runs a mode in turns, "
            f"median (min-max) ms: "
            + "; ".join(f"{m} {meds[m]:.3f} ({min(w) * 1e3:.3f}-{max(w) * 1e3:.3f})" for m, w in runs.items())
            + "; on/off " + f"{meds['on'] / meds['off']:.4f}"
            + (f", fenced/off {meds['fenced'] / meds['off']:.4f}" if "fenced" in meds else "")
            + f"  [{card}]")

    # (c) a tracing.trace window over the warm OR, timeline on (the port's spans)
    calls = 3
    or_()
    tl.configure(mode="on")
    with tempfile.TemporaryDirectory(prefix="rb_trace_") as logdir:
        with tracing.trace(logdir) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                with tracing.annotate("phase16.warm_or"):
                    or_()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / calls
        chrome = json.loads(open(os.path.join(logdir, tracing.TRACE_FILE)).read())
    tl.configure(mode="off")
    tl.RECORDER.clear()
    ranges = {e.key for e in prof.key_averages()}
    if not {"agg.device", "phase16.warm_or"} <= ranges:
        fail(f"(c) the span names are missing from the profiler window: "
             f"{sorted(k for k in ranges if '.' in k)[:20]}")
    busy_us, kernels = _trace_busy(chrome, calls)
    kern = {name: sum(v for k, v in kernels.items() if name in k)
            for name in ("group_reduce_kernel", "popcount_rows_kernel")}
    if all(kern.values()):
        top = "; ".join(f"{k[:50]} {v / 1e3:.4f} ms" for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:4])
        say(f"[observe] (c) tracing.trace over {calls} warm ORs (per call): wall {wall * 1e3:.3f} ms, "
            f"device busy {busy_us / 1e3:.4f} ms (kernels, copies and memsets of the Chrome trace, "
            f"overlaps merged), idle share {1 - busy_us / 1e6 / wall:.2%}; group_reduce_kernel "
            f"{kern['group_reduce_kernel'] / 1e3:.4f} ms, popcount_rows_kernel "
            f"{kern['popcount_rows_kernel'] / 1e3:.4f} ms; kernels: {top}; the Chrome trace holds "
            f"{len(chrome['traceEvents'])} events; ranges agg.device and phase16.warm_or present  [{card}]")
    else:
        wall_e, busy_ms, by = _event_busy(or_, calls)
        say(f"[observe] (c) tracing.trace over {calls} warm ORs showed no device time for "
            f"{[k for k, v in kern.items() if not v]} (kernels {sorted(kernels)[:6]}); CUDA events "
            f"around the kernel wrappers instead (per call): wall {wall_e * 1e3:.3f} ms, kernels busy "
            f"{busy_ms:.4f} ms, idle share {1 - busy_ms / 1e3 / wall_e:.2%}; {by}  [{card}]")
        if not by.get("group_reduce") or not by.get("popcount_rows"):
            fail("(c) neither the profiler nor CUDA events saw the reduce and popcount kernels")

    # (d) faults on the card
    retry0 = insights.robust_counters()["retry"].get("store.ship/recovered", 0)
    store.PACK_CACHE.close()
    with faults.inject("store.ship", robust.TransientDeviceError, every=1, times=1) as inj:
        r = or_()
    if inj.fired != 1 or r.serialize() != ref[0]:
        fail(f"(d) transient store.ship fault: fired {inj.fired}, bytes equal {r.serialize() == ref[0]}")
    if insights.robust_counters()["retry"].get("store.ship/recovered", 0) != retry0 + 1:
        fail("(d) the transient store.ship fault was not counted recovered")
    say(f"[observe] (d) a transient store.ship fault on the card: retried, counted recovered, the OR "
        f"equal to the reference bytes  [{card}]")
    store.PACK_CACHE.close()
    answer = None
    with faults.inject("store.expand", robust.simulated_oom, every=1) as inj:
        try:
            answer = or_()
        except torch.cuda.OutOfMemoryError as e:
            if errors.classify(e) != errors.RESOURCE:
                fail(f"(d) simulated OOM classified {errors.classify(e)}")
    if answer is not None or not inj.fired:
        fail("(d) simulated_oom at store.expand returned an answer instead of raising")
    say(f"[observe] (d) simulated_oom at store.expand raised torch.cuda.OutOfMemoryError "
        f"(classified resource, fired {inj.fired}), no answer returned  [{card}]")
    store.PACK_CACHE.close()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    try:
        torch.empty(total * 2, dtype=torch.uint8, device="cuda")
        fail("(d) an allocation of twice the card's memory did not raise")
    except torch.cuda.OutOfMemoryError as e:
        cat = errors.classify(e)
        if cat != errors.RESOURCE:
            fail(f"(d) a real torch.cuda.OutOfMemoryError classified {cat}")
    torch.cuda.empty_cache()
    say(f"[observe] (d) a real torch.cuda.OutOfMemoryError ({2 * total} bytes asked) classified "
        f"resource  [{card}]")
    robust.LADDER.reset()
    say(f"[observe] phase 16 took {time.perf_counter() - t_phase:.1f} s  [{card}]")
    return launches


OBSERVATORY_RUNS = 10  # warm wide ORs per sentinel mode (off, armed), in turns
OBSERVATORY_TICKS = 20  # lone sentinel ticks per median
OBSERVATORY_PAIRS = 2_000  # phase 9's window: run-optimized adjacent census pairs
OBSERVATORY_FUSED = 8  # queries in (d)'s fused window
OBSERVATORY_LEFTS = 320  # (g)'s all-pairs lefts against the 10,000 bitmaps
# the kernels of phase 17's path: it fails if one of them has no launch
OBSERVATORY_KERNELS = ("rb_expand_rows", "rb_popcount_rows", "rb_threshold", "rb_pair_rows",
                       "rb_pair_rows[counts]", "rb_pairwise_and_card")
# the locks the port wraps (the JAX package's seven less its tracing lock)
FRAMEWORK_LOCKS = ("agg.pool", "native.loader", "observe.registry", "query.cache",
                   "query.exec.plan_memo", "query.expr.intern")


def phase_observatory(base, bitmaps, real, card: str):
    """Phase 17: the rest of observe on the card at full size — (a) the
    pack cache reconciled against the card's allocator, (b) the health
    sentinel inline on the dispatch, (c) a red episode's flight bundle, (d)
    lock-wait stats, (e) the columnar device tier with its decisions,
    outcomes and fault sites, (f) the structure ledger's census, (g) the
    batch spans. Returns the launch counts of the phase's path."""
    import tempfile

    from roaringbitmap_tpu_torch import FastAggregation, ParallelAggregation, RoaringBitmap
    from roaringbitmap_tpu_torch import columnar, insights, native, observe, tracing
    from roaringbitmap_tpu_torch import query as tq
    from roaringbitmap_tpu_torch.columnar import device as cdev
    from roaringbitmap_tpu_torch.columnar import engine as E
    from roaringbitmap_tpu_torch.observe import (
        artifacts, bundle, decisions, health, lockstats, outcomes, sentinel, structure,
    )
    from roaringbitmap_tpu_torch.ops import kernels as K
    from roaringbitmap_tpu_torch.parallel import batch, store
    from roaringbitmap_tpu_torch.robust import errors, faults, ladder

    t_phase = time.perf_counter()
    authorities = _authority_snapshot()  # the armed sentinel's refit and (e)'s calibration move them
    oracle_or = np.unique(np.concatenate(base[:min(len(base), len(bitmaps))]))
    q1, want_q1, _sets, _parts = _q1_setup(base, bitmaps, real)

    def or_():
        return FastAggregation.or_(*bitmaps)

    def q1_():
        return tq.execute(q1, cache=None)

    sentinel.configure(inline=False)
    sentinel.SENTINEL.reset()
    outcomes.reset()
    ladder.LADDER.reset()
    K.reset_launches()  # --- phase 17's path, counts live from here ---

    # (a) the reconciliation with a 2.52 GB pack resident
    store.PACK_CACHE.close()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_or = or_()
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    _check("(a) FastAggregation.or_ cold, the pack kept resident", ref_or, oracle_or, "[observatory]")
    recon = store.hbm_reconciliation()
    entries = [e for e in store.PACK_CACHE._entries.values()]
    entry_bytes = sum(e.nbytes for e in entries)
    jax_probe = max(abs(recon["ledger_drift_bytes"]), abs(recon.get("device_drift_bytes", 0)))
    jax_level = health.LEVEL_NAMES[next(r for r in health.DEFAULT_RULES
                                        if r.name == "hbm-accounting-drift").band(jax_probe)]
    say(f"[observatory] (a) cold OR {cold_ms:.1f} ms; hbm_reconciliation: gauge {recon['gauge_bytes']} "
        f"bytes, ledger {recon['ledger_bytes']}, entries {recon['entries']} ({entry_bytes} bytes), "
        f"ledger drift {recon['ledger_drift_bytes']}; device: resident {recon.get('device_resident_bytes')}, "
        f"torch.cuda.memory_allocated {recon.get('device_bytes_in_use')}, drift "
        f"{recon.get('device_drift_bytes')} bytes, pending {recon.get('device_pending_bytes')}; the JAX rule's max |drift| would read {jax_probe} "
        f"bytes ({jax_level}), the port's sign rule reads "
        f"{max(0, recon.get('device_drift_bytes', 0), abs(recon['ledger_drift_bytes']))}  [{card}]")
    if recon["ledger_drift_bytes"] != 0:
        fail(f"(a) ledger drift {recon['ledger_drift_bytes']} bytes, expected 0")
    if "device_drift_bytes" not in recon:
        fail("(a) the reconciliation has no device keys with a pack resident on the card")
    if recon["device_drift_bytes"] > 0:
        fail(f"(a) device drift {recon['device_drift_bytes']} bytes > 0: the gauge claims freed memory")
    if recon["gauge_bytes"] != entry_bytes or recon["entry_sum_bytes"] != entry_bytes:
        fail(f"(a) the gauge {recon['gauge_bytes']} differs from the resident entries' {entry_bytes} bytes")
    mem0 = torch.cuda.memory_allocated()
    store.PACK_CACHE.close()
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    after = store.hbm_reconciliation()
    say(f"[observatory] (a) PACK_CACHE.close(): gauge {after['gauge_bytes']} bytes; "
        f"torch.cuda.memory_allocated {mem0} -> {mem1} (freed {mem0 - mem1}, the entries held "
        f"{entry_bytes})  [{card}]")
    if after["gauge_bytes"] != 0 or after["ledger_drift_bytes"] != 0:
        fail(f"(a) after close(): gauge {after['gauge_bytes']}, ledger drift {after['ledger_drift_bytes']}")
    if mem0 - mem1 < entry_bytes:
        fail(f"(a) close() freed {mem0 - mem1} bytes on the card, less than the {entry_bytes} released")

    # (b) the sentinel inline on the main path, the pack resident
    ref_or = or_()
    ref = (ref_or.serialize(), q1_().serialize())
    sentinel.SENTINEL.reset()
    ticks0 = sentinel.SENTINEL._tick_no
    sentinel.configure(inline=True, inline_interval_s=0.0)
    try:
        got = [or_().serialize() for _ in range(3)] + [q1_().serialize()]
    finally:
        sentinel.configure(inline=False, inline_interval_s=sentinel.DEFAULT_INTERVAL_S)
    ticked = sentinel.SENTINEL._tick_no - ticks0
    if got != [ref[0]] * 3 + [ref[1]]:
        fail("(b) the warm OR or Q1 with the sentinel armed differs from the sentinel-off bytes")
    if ticked < 4:
        fail(f"(b) the armed sentinel ticked {ticked} times over 4 dispatches or more")
    states = sentinel.SENTINEL.rule_states()
    level, name = sentinel.SENTINEL.status()
    not_green = {r: st["level_name"] for r, st in states.items() if st["level"] != health.OK}
    say(f"[observatory] (b) the sentinel armed inline (interval 0): 3 warm ORs and Q1 equal to the "
        f"sentinel-off bytes, {ticked} ticks, status {name}, every one of {len(states)} rules "
        f"{'ok' if not not_green else not_green}; hbm-accounting-drift value "
        f"{states['hbm-accounting-drift']['value']}  [{card}]")
    if level != health.OK or not_green:
        fail(f"(b) the sentinel is {name} with the pack resident: {not_green}")
    runs = {"off": [], "armed": []}
    for _ in range(OBSERVATORY_RUNS):
        for mode in runs:
            sentinel.configure(inline=mode == "armed", inline_interval_s=0.0)
            t0 = time.perf_counter()
            or_()
            runs[mode].append(time.perf_counter() - t0)
    sentinel.configure(inline=False, inline_interval_s=sentinel.DEFAULT_INTERVAL_S)
    tick_s = []
    for _ in range(OBSERVATORY_TICKS):
        t0 = time.perf_counter()
        sentinel.SENTINEL.tick()
        tick_s.append(time.perf_counter() - t0)
    meds = {m: float(np.median(w)) * 1e3 for m, w in runs.items()}
    say(f"[observatory] (b) health supervision overhead: warm FastAggregation.or_, {OBSERVATORY_RUNS} "
        f"runs a mode in turns, median (min-max) ms: "
        + "; ".join(f"{m} {meds[m]:.3f} ({min(w) * 1e3:.3f}-{max(w) * 1e3:.3f})" for m, w in runs.items())
        + f"; armed/off {meds['armed'] / meds['off']:.4f}; one SENTINEL.tick() alone, median of "
        f"{OBSERVATORY_TICKS}: {float(np.median(tick_s)) * 1e3:.3f} ms (min {min(tick_s) * 1e3:.3f}, "
        f"max {max(tick_s) * 1e3:.3f})  [{card}]")
    if sentinel.SENTINEL.status()[0] != health.OK:
        fail(f"(b) the sentinel left green over the timed ticks: {sentinel.SENTINEL.rule_states()}")

    # (c) a red episode: a breaker held open by store.ship faults
    with tempfile.TemporaryDirectory(prefix="rb_bundle_") as sink:
        prev_sink = artifacts.artifact_dir()
        artifacts.configure(dir=sink)
        ladder.LADDER.configure(trip_after=1)
        ladder.LADDER.reset()  # breakers take the policy when created
        try:
            subset = bitmaps[: len(bitmaps) // 2]  # not resident: its ship fails
            with faults.inject("store.ship", every=1) as inj:
                try:
                    FastAggregation.or_(*subset)
                    fail("(c) the OR under store.ship faults returned an answer")
                except errors.TransientDeviceError:
                    pass
            if ladder.LADDER.states().get("agg/device") != "open":
                fail(f"(c) the device breaker did not open: {ladder.LADDER.states()}")
            ages = ladder.LADDER.open_ages(now=time.monotonic() + 400.0)
            reds = []
            for k in range(3):  # on an injected clock 400 s past the trip
                snap = health.snapshot(prev_sums=dict(sentinel.SENTINEL._prev_sums), now=1e6 + k)
                snap.breaker_open_ages = ages
                reds.append(sentinel.SENTINEL.tick(now=1e6 + k, snap=snap))
            bundles = [a for r in reds for a in r["actuated"] if a["kind"] == "bundle"]
            names = sorted(os.listdir(sink))
            if reds[0]["status_name"] != "red" or reds[0]["rules"]["breaker-stuck-open"]["level"] != health.CRITICAL:
                fail(f"(c) breaker-stuck-open did not go red: {reds[0]['rules']['breaker-stuck-open']}")
            if len(bundles) != 1 or "error" in bundles[0] or len(names) != 1:
                fail(f"(c) expected one bundle over the red episode, got {bundles} ({names})")
            manifest = bundle.read_manifest(bundles[0]["path"], verify=True)
            sections = sorted(manifest["files"])
            want_sections = ["calibration.json", "decisions.json", "health.json", "metrics.jsonl",
                             "observatory.json", "outcomes.json", "timeline.jsonl"]
            if sections != want_sections:
                fail(f"(c) the bundle's sections are {sections}, expected {want_sections}")
            obs = json.loads(open(os.path.join(bundles[0]["path"], "observatory.json")).read())
            hbm = obs.get("hbm", {})
            if "device_drift_bytes" not in hbm or hbm.get("ledger_drift_bytes") != 0:
                fail(f"(c) the bundle's observatory.json lacks the device reconciliation: {hbm}")
            if hbm["device_drift_bytes"] > 0 or reds[0]["rules"]["hbm-accounting-drift"]["level"]:
                fail(f"(c) the red episode's reconciliation claims more than the card holds: {hbm}")
            size = sum(m["bytes"] for m in manifest["files"].values())
            say(f"[observatory] (c) {inj.fired} store.ship faults opened agg/device; "
                f"breaker-stuck-open red on the injected clock (age {min(ages.values()):.1f} s); one "
                f"bundle ({names[0]}, {size} bytes) verified: sections {sections}; its "
                f"observatory.json holds hbm with device keys (device drift "
                f"{hbm['device_drift_bytes']} bytes, the failed working set's unbuilt rows pending "
                f"{hbm['device_pending_bytes']} bytes, ledger drift {hbm['ledger_drift_bytes']})  [{card}]")
        finally:
            artifacts.configure(dir=prev_sink)
            ladder.LADDER.configure(trip_after=3)
            ladder.LADDER.reset()
            sentinel.SENTINEL.reset()
            faults.clear()

    # (d) lock-wait stats over the warm OR, Q1 and a fused window
    Q = tq.Q

    def window():
        return [Q.or_(*bitmaps[i * 40:(i + 1) * 40]) & Q.or_(*bitmaps[(i + 1) * 40:(i + 2) * 40])
                for i in range(OBSERVATORY_FUSED)]

    want_fused = [tq.execute(q, cache=None).serialize() for q in window()]
    tq.DEFAULT_CACHE.clear()
    lockstats.install()
    try:
        got = (or_().serialize(), q1_().serialize(),
               ParallelAggregation.or_(*bitmaps[:100]).serialize())
        # built under the proxies (the expression intern table's lock) and
        # run through the default result cache (its lock)
        got_fused = [r.serialize() for r in tq.execute_fused(window())]
        with native._LOCK:  # taken by the first load only: acquired here through its proxy
            pass
        installed = lockstats.installed()
        stats = lockstats.wait_stats()
    finally:
        lockstats.uninstall()
    if got[:2] != ref or got_fused != want_fused:
        fail("(d) a result with the lock proxies installed differs from the uninstalled bytes")
    if got[2] != FastAggregation.or_(*bitmaps[:100]).serialize():
        fail("(d) ParallelAggregation.or_ differs from FastAggregation.or_")
    if installed != sorted(FRAMEWORK_LOCKS) or not set(FRAMEWORK_LOCKS) <= set(stats):
        fail(f"(d) installed {installed}, waits recorded for {sorted(stats)}")
    say(f"[observatory] (d) lockstats over the warm OR, Q1, ParallelAggregation.or_ and "
        f"{OBSERVATORY_FUSED} fused queries: bytes equal uninstalled; waits (count, p99 us): "
        + ", ".join(f"{k} {v['count']} {v['p99'] * 1e6:.2f}" for k, v in sorted(stats.items())
                    if k in FRAMEWORK_LOCKS) + f"  [{card}]")

    # (e) the columnar device tier with decisions and outcomes on
    t0 = time.perf_counter()
    clones = [b.clone() for b in bitmaps[:OBSERVATORY_PAIRS + 1]]
    for c in clones:
        c.run_optimize()
    pairs = list(zip(clones[:-1], clones[1:]))
    columnar.MODEL.reset()
    model = columnar.ensure_calibrated()
    store.PACK_CACHE.close()  # the calibration's own synthetic rows go
    outcomes.reset()
    decisions.LOG.clear()
    E.reset_counts()
    routed = {}
    for op in PAIR_OPS:
        fn = getattr(RoaringBitmap, FACADE[op])
        want = columnar.pairwise_multi(op, pairs, tier="device")
        got = [fn(x, y) for x, y in pairs]
        if got != want:
            fail(f"(e) the routed facade's {op} differs from the device tier's over {len(pairs)} pairs")
        routed[op] = sum(r.get_cardinality() for r in got)
    cut = [e for e in decisions.decisions() if e["site"] == "columnar.cutoff"]
    joined = [e for e in outcomes.tail() if e["site"] == "columnar.cutoff"]
    samples = outcomes.samples("columnar.cutoff")
    if not cut or not joined or not samples:
        fail(f"(e) columnar.cutoff: {len(cut)} decisions, {len(joined)} joins, {len(samples)} samples")
    for c in clones:
        cdev.rows_for(c)
    colrows = [e for e in store.PACK_CACHE._entries.values() if e.kind == "colrows"]
    col_bytes = sum(e.nbytes for e in colrows)
    resident = sum(cdev.rows_resident(c) for c in clones)
    rows_bytes = sum(c.get_container_count() for c in clones) * ROW_BYTES
    if resident != len(clones) or len(colrows) != len(clones) or col_bytes != rows_bytes:
        fail(f"(e) rows_resident {resident} of {len(clones)}, {len(colrows)} colrows entries, "
             f"{col_bytes} bytes against {rows_bytes}")
    want_or = columnar.pairwise_multi("or", pairs, tier="cpu")
    retried0 = insights.robust_counters()["retry"].get("columnar.device/recovered", 0)
    with faults.inject("columnar.device", every=1, times=1) as inj:
        got = columnar.pairwise_multi("or", pairs, tier="device")
    if inj.fired != 1 or got != want_or:
        fail(f"(e) a transient columnar.device fault: fired {inj.fired}, result equal {got == want_or}")
    if insights.robust_counters()["retry"].get("columnar.device/recovered", 0) != retried0 + 1:
        fail("(e) the transient columnar.device fault was not counted recovered")
    try:
        with faults.inject("columnar.kernel", every=1, times=1):
            columnar.pairwise("and", *pairs[0], tier="cpu")
        fail("(e) a columnar.kernel fault returned an answer")
    except errors.TransientDeviceError as e:
        if errors.classify(e) != errors.TRANSIENT:
            fail(f"(e) the columnar.kernel fault classified {errors.classify(e)}")
    say(f"[observatory] (e) the routed facade (and_/or_/xor/andnot) over {len(pairs)} run-optimized "
        f"census pairs equal to the device tier ({routed}); model {'calibrated' if model.calibrated else 'gate'}; "
        f"columnar.cutoff: {len(cut)} decisions, {len(joined)} joined, {len(samples)} refit samples; "
        f"verdicts {dict(E.ROUTE_COUNTS)}; drift cells {outcomes.drift()}; rows_resident for all "
        f"{resident} operands = {len(colrows)} colrows entries, {col_bytes} bytes; a transient "
        f"columnar.device fault retried on the card (result equal); a columnar.kernel fault raised "
        f"TransientDeviceError, classified transient; {time.perf_counter() - t0:.1f} s  [{card}]")
    del clones, pairs, want, got, want_or
    store.PACK_CACHE.close()

    # (f) the structure ledger's census of the working set
    t0 = time.perf_counter()
    structure.LEDGER.reset()
    structure.LEDGER.watch("census", bitmaps)
    st = structure.LEDGER.refresh()
    refresh_s = time.perf_counter() - t0
    host = {"array": 0, "bitmap": 0, "run": 0}
    for bm in bitmaps:
        for c in bm.high_low_container.containers:
            host[c.TYPE] += 1
    again = structure.LEDGER.refresh()
    say(f"[observatory] (f) structure census of {len(bitmaps)} bitmaps: {st['containers']} "
        f"({sum(st['containers'].values())} containers; host count {host}); actual "
        f"{st['actual_bytes']} bytes, optimal {st['optimal_bytes']}, drift ratio {st['drift_ratio']}, "
        f"fragmentation p99 {st['fragmentation_p99']}; refresh {refresh_s:.2f} s, a clean refresh "
        f"re-measured {again['dirty_refreshed']}  [{card}]")
    if st["containers"] != host or again["dirty_refreshed"] != 0:
        fail(f"(f) the ledger's census {st['containers']} differs from the host count {host}")
    structure.LEDGER.reset()

    # (g) the batch spans: a census facet count and a 320 x 10,000 matrix
    spans0 = {k: v["count"] for k, v in tracing.timings().items()}
    pw0 = dict(batch.PAIRWISE_COUNTS)
    filt = FastAggregation.or_(*bitmaps[:67])
    facet = batch.batched_cardinality(filt, bitmaps)
    facet_want = np.array([RoaringBitmap.and_cardinality(b, filt) for b in bitmaps[:FACET_SAMPLE]])
    if not np.array_equal(facet[:FACET_SAMPLE], facet_want):
        fail("(g) the facet count differs from and_cardinality")
    matrix = batch.pairwise_and_cardinality(bitmaps[:OBSERVATORY_LEFTS], bitmaps)
    check = [(i, j) for i in range(0, OBSERVATORY_LEFTS, 53) for j in range(0, len(bitmaps), 997)]
    if any(matrix[i, j] != RoaringBitmap.and_cardinality(bitmaps[i], bitmaps[j]) for i, j in check):
        fail("(g) the all-pairs matrix differs from and_cardinality")
    spans = {k: v["count"] - spans0.get(k, 0) for k, v in tracing.timings().items()
             if k.startswith("batch.") and v["count"] != spans0.get(k, 0)}
    pw = {k: batch.PAIRWISE_COUNTS[k] - pw0.get(k, 0) for k in batch.PAIRWISE_COUNTS}
    say(f"[observatory] (g) a facet count over {len(bitmaps)} bitmaps and a {OBSERVATORY_LEFTS} x "
        f"{len(bitmaps)} all-pairs matrix: spans {spans}; rb_tpu_batch_pairwise_total moved {pw}  [{card}]")
    if spans.get("batch.one_vs_many.and") != 1 or sum(v for k, v in spans.items()
                                                       if k.startswith("batch.pairwise.")) != 1:
        fail(f"(g) the batch spans are {spans}")
    if sum(pw.values()) != 1:
        fail(f"(g) rb_tpu_batch_pairwise_total moved {pw}")

    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    say(f"[observatory] launches over phase 17's path: {launches}  [{card}]")
    for name in OBSERVATORY_KERNELS:
        if not launches.get(name):
            fail(f"kernel {name} was not launched on phase 17's path")
    outcomes.reset()
    decisions.LOG.clear()
    store.PACK_CACHE.close()
    _restore_authorities("[observatory]", authorities)
    say(f"[observatory] phase 17 took {time.perf_counter() - t_phase:.1f} s  [{card}]")
    return launches

def _authority_snapshot():
    """Every pricing authority's state and the dispatcher's device gate,
    deep-copied (a calibrated columnar model adopts the dict it loads)."""
    from roaringbitmap_tpu_torch import cost
    from roaringbitmap_tpu_torch.parallel import aggregation

    states = {name: cost.authority(name).state() for name in cost.names()}
    return json.loads(json.dumps(states)), aggregation.config.min_device_containers


def _restore_authorities(tag: str, snap) -> None:
    """Put back what ``_authority_snapshot`` saw, and fail the phase if any
    authority's state or the device gate still differs (a moved gate would
    route phase 9's and every later phase's aggregations differently)."""
    from roaringbitmap_tpu_torch import cost
    from roaringbitmap_tpu_torch.parallel import aggregation

    states, gate = snap
    for name, st in states.items():
        # an uncalibrated or default state is not loadable: reset to it
        if not cost.authority(name).load_state(json.loads(json.dumps(st))):
            cost.authority(name).reset()
    aggregation.config.min_device_containers = gate
    changed = [name for name, st in states.items()
               if json.loads(json.dumps(cost.authority(name).state())) != st]
    if changed or aggregation.config.min_device_containers != gate:
        fail(f"{tag} left authorities {changed} or the device gate "
             f"({aggregation.config.min_device_containers}, was {gate}) changed")
    say(f"{tag} the {len(states)} authorities' states and min_device_containers = {gate} "
        f"restored as the phase found them")


TENANT_REQUESTS = 200  # (c): the harness's schedule
TENANT_WARMUP = 24  # (c): requests before the health rules' arming tick
TENANT_THREADS = 8
SWEEP_PREFIXES = (2, 3, 4, 8, 16, 32, 64, 128, 256)  # ~60 to ~7,900 containers (one bitmap is a clone)
SWEEP_TURNS = 2  # warm runs of each tier per prefix, the tiers in turns
TENANT_KERNELS = ("rb_expand_rows", "rb_group_reduce", "rb_popcount_rows", "rb_threshold")


def phase_tenants(base, bitmaps, real, card: str):
    """Phase 18: the cost facade and the serving read path on the card —
    (a) the breakeven sweep and the measured device gate, (b) residency
    pricing of two census working sets that evict each other, (c) the load
    harness with three declared tenants, (d) the sentinel's refit and
    autotune actuations, a red episode's calibration.json and the cost
    state's round trip. Every authority and the device gate are restored as
    the phase found them. Returns the launch counts of the phase's path."""
    import tempfile

    from roaringbitmap_tpu_torch import FastAggregation, cost, insights
    from roaringbitmap_tpu_torch import query as tq
    from roaringbitmap_tpu_torch import serve
    from roaringbitmap_tpu_torch.cost import breakeven, residency
    from roaringbitmap_tpu_torch.observe import (
        artifacts, bundle, decisions, health, outcomes, sentinel,
    )
    from roaringbitmap_tpu_torch.ops import kernels as K
    from roaringbitmap_tpu_torch.parallel import aggregation, store
    from roaringbitmap_tpu_torch.query import fusion
    from roaringbitmap_tpu_torch.robust import faults, ladder
    from roaringbitmap_tpu_torch.serve import slo

    t_phase = time.perf_counter()
    authorities = _authority_snapshot()
    nb = len(base)
    if (aggregation.config.device, aggregation.config.mode) != ("cuda", "auto"):
        fail(f"aggregation config is {aggregation.config.device}/{aggregation.config.mode}, "
             "expected cuda/auto")
    oracle_all = np.unique(np.concatenate(base[:min(nb, len(bitmaps))]))
    sentinel.configure(inline=False)
    outcomes.reset()
    decisions.LOG.clear()
    ladder.LADDER.reset()
    slo.reset()
    K.reset_launches()  # --- phase 18's path, counts live from here ---

    # (a) the breakeven sweep: census prefixes, device and CPU tiers in turns
    t0 = time.perf_counter()
    prefixes = [n for n in SWEEP_PREFIXES if n <= len(bitmaps)]
    rows = {}
    for n in prefixes:
        sub = bitmaps[:n]
        rows[n] = sum(b.get_container_count() for b in sub)
        want = np.unique(np.concatenate([base[i % nb] for i in range(n)]))
        got = FastAggregation.or_(*sub, mode="device")  # the cold pack: not a sample
        if not np.array_equal(got.to_array(), want):
            fail(f"(a) the device OR of the first {n} bitmaps differs from numpy")
    outcomes.reset()
    walls = {"device": [], "cpu": []}
    for _ in range(SWEEP_TURNS):
        for n in prefixes:
            sub = bitmaps[:n]
            want = None
            for mode in ("device", "cpu"):
                t1 = time.perf_counter()
                got = FastAggregation.or_(*sub, mode=mode)
                walls[mode].append(time.perf_counter() - t1)
                arr = got.to_array()
                if want is None:
                    want = np.unique(np.concatenate([base[i % nb] for i in range(n)]))
                if not np.array_equal(arr, want):
                    fail(f"(a) the {mode} OR of the first {n} bitmaps differs from numpy")
    joined = [e for e in outcomes.tail() if e["site"] == "agg.dispatch"]
    by_tier = {}
    for e in joined:
        by_tier.setdefault(e["engine"], set()).add(e["inputs"]["rows"])
    counts = {t: sum(1 for e in joined if e["engine"] == t) for t in by_tier}
    if counts.get("device", 0) < 6 or len(by_tier.get("device", ())) < 2 or \
            sum(c for t, c in counts.items() if t != "device") < 6:
        fail(f"(a) agg.dispatch joins per tier {counts}, row counts {by_tier}")
    gate0 = aggregation.config.min_device_containers
    rep = breakeven.MODEL.refit_from_outcomes()
    view = breakeven.MODEL.curves_view()
    say(f"[tenants] (a) breakeven sweep over {len(prefixes)} census prefixes ({rows[prefixes[0]]} to "
        f"{rows[prefixes[-1]]} containers), device and CPU tiers in turns, {SWEEP_TURNS} runs each, "
        f"every result equal to numpy; joins {counts}; refit: curves (overhead us, us a row) "
        f"{view['tiers']}, measured gate {view['gate_rows']} (min_device_containers {gate0} -> "
        f"{view['config_min_device_containers']}; the JAX default is 64), rejected {rep['rejected']}, "
        f"provenance {rep['provenance']}, backend {breakeven.MODEL.backend}; "
        f"{time.perf_counter() - t0:.1f} s  [{card}]")
    if breakeven.MODEL.backend != "cuda":
        fail(f"(a) the breakeven state is stamped {breakeven.MODEL.backend!r}, expected 'cuda'")
    if view["gate_rows"] is not None and aggregation.config.min_device_containers != view["gate_rows"]:
        fail("(a) the measured gate did not reach the dispatcher on the card")
    aggregation.config.min_device_containers = gate0  # (b)-(d) route as the phase found them

    # (b) residency: two census halves evicting each other
    t0 = time.perf_counter()
    halves = (bitmaps[: len(bitmaps) // 2], bitmaps[len(bitmaps) // 2:])
    store.PACK_CACHE.close()
    prev_budget = store.PACK_CACHE.max_bytes
    FastAggregation.or_(*halves[0], mode="device")
    one = store.PACK_CACHE.stats()["bytes"]
    store.PACK_CACHE.configure(max_bytes=int(one * 1.5))
    try:
        repacks = []
        for k in range(4):  # W1 W2 W1 W2 after W1: three evictions, three regret joins
            half = halves[(k + 1) % 2]
            t1 = time.perf_counter()
            got = FastAggregation.or_(*half, mode="device")
            repacks.append(time.perf_counter() - t1)
            if not np.array_equal(got.to_array(), oracle_all):
                fail("(b) a census half's OR differs from numpy")
        evict_joins = [e for e in outcomes.tail() if e["site"] == "pack_cache.evict"]
        rrep = residency.MODEL.refit_from_outcomes()
        learned = residency.MODEL.repack_estimate("agg")
        if not learned or not evict_joins:
            fail(f"(b) no learned repack_s for agg: joins {len(evict_joins)}, report {rrep}")
        seq0 = decisions.decisions()[-1]["seq"] if decisions.decisions() else 0
        FastAggregation.or_(*halves[1], mode="device")  # evicts the other half, priced
        priced = [e for e in decisions.decisions()
                  if e["site"] == "pack_cache.evict" and e["seq"] > seq0]
        if not priced or "est_us" not in priced[-1]["inputs"]:
            fail(f"(b) the eviction after the refit carries no est_us: {priced[-1:] }")
        est = priced[-1]["inputs"]["est_us"]
        t1 = time.perf_counter()
        FastAggregation.or_(*halves[0], mode="device")  # its return: the re-pack
        back_s = time.perf_counter() - t1
        join = [e for e in outcomes.tail() if e["site"] == "pack_cache.evict"
                and e["seq"] == priced[-1]["seq"]]
        if not join:
            fail("(b) the priced eviction's return did not join")
        say(f"[tenants] (b) two census halves ({one} bytes resident each) under a "
            f"{int(one * 1.5)}-byte budget: {store.PACK_CACHE.stats()['evictions']} evictions, "
            f"{len(evict_joins)} regret joins, cold ORs {', '.join(f'{w * 1e3:.1f}' for w in repacks)} ms; "
            f"learned repack_s[agg] {learned:.6f} s (provenance {rrep['provenance']}); the next "
            f"eviction's est_us {est}; the re-pack wall it then measured {join[0]['measured_s'] * 1e6:.1f} us "
            f"(error ratio {join[0].get('error_ratio')}), the whole OR {back_s * 1e3:.1f} ms  [{card}]")
    finally:
        store.PACK_CACHE.configure(max_bytes=prev_budget)
        store.PACK_CACHE.close()

    # (c) the harness: three declared tenants, 8 threads, closed loop
    t0 = time.perf_counter()
    Q = tq.Q
    q1, _want_q1, (A, B, C, _head), (_uA, _uB, _uC, abc, _t2) = _q1_setup(base, bitmaps, real)
    core = (Q.or_(*A) & Q.or_(*B)) - Q.or_(*C)
    n_heads = max(1, min(10, len(bitmaps) // Q1_HEAD))

    drawn = {}  # expression uid -> (head, k), for the numpy check

    def q1_mix(rng, corpus, shared):
        j = int(rng.integers(0, n_heads))
        k = int(rng.integers(2, 4))
        expr = core | Q.threshold(k, *corpus[j * Q1_HEAD:(j + 1) * Q1_HEAD])
        drawn[expr.uid] = (j, k)
        return expr

    def q1_oracle(j, k):
        v, c = np.unique(np.concatenate([base[(j * Q1_HEAD + i) % nb] for i in range(Q1_HEAD)]),
                         return_counts=True)
        return np.union1d(abc, v[c >= k])

    profiles = [
        serve.TenantProfile("interactive", weight=2.0, quota_qps=1e6, latency_class="interactive"),
        serve.TenantProfile("batch-q1", weight=1.0, quota_qps=1e6, mix=q1_mix),
        serve.TenantProfile("low-quota", weight=1.0, quota_qps=2.0, burst=2.0,
                            latency_class="balanced"),
    ]
    adm = serve.AdmissionController(max_inflight=2 * TENANT_THREADS, queue_limit=0)
    harness = serve.LoadHarness(bitmaps, profiles, threads=TENANT_THREADS, admission=adm)
    # a warm-up window: the packs resident, every tenant's series minted
    # before the health rules' arming tick (first sight counts nothing)
    harness.run(serve.build_requests(bitmaps, profiles, TENANT_WARMUP, seed=SEED + 1))
    rules = {r.name: r for r in health.DEFAULT_RULES
             if r.name in ("serving-p99-breach", "tenant-saturation", "serving-p99-pressure")}
    arm = health.snapshot(refresh_hbm=False)
    for r in rules.values():
        r.probe(arm)
    hedge_series = insights.fusion_counters()["hedges"]
    solo0 = hedge_series.get("solo", 0)
    reqs = serve.build_requests(bitmaps, profiles, TENANT_REQUESTS, seed=SEED)
    t1 = time.perf_counter()
    report = harness.run(reqs)
    run_s = time.perf_counter() - t1
    probed = health.snapshot(prev_sums=arm.sums, refresh_hbm=False)
    values = {name: r.probe(probed) for name, r in rules.items()}
    solo = insights.fusion_counters()["hedges"].get("solo", 0) - solo0
    t1 = time.perf_counter()
    oracle = harness.run_serial(reqs)
    serial_s = time.perf_counter() - t1
    mismatched = [i for i, (g, w) in enumerate(zip(report.results, oracle))
                  if not isinstance(g, serve.ShedRejection) and g.serialize() != w.serialize()]
    if mismatched:
        fail(f"(c) {len(mismatched)} served results differ from run_serial (first at {mismatched[0]})")
    bad_sheds = [r for r in report.results if r is None or (
        not isinstance(r, serve.ShedRejection) and not hasattr(r, "serialize"))]
    if bad_sheds:
        fail(f"(c) {len(bad_sheds)} result slots hold neither a bitmap nor a ShedRejection")
    checked = 0
    for req, got in zip(reqs, report.results):  # the batch tenant's answers against numpy
        if req.tenant == "batch-q1" and not isinstance(got, serve.ShedRejection) and checked < 6:
            j, k = drawn[req.expr.uid]
            if not np.array_equal(got.to_array(), q1_oracle(j, k)):
                fail(f"(c) a Q1-shaped answer (head {j}, k = {k}) differs from numpy")
            checked += 1
    tenant_rows = report.tenant_rows()
    if report.stats["low-quota"].shed == 0 or report.stats["interactive"].shed or \
            report.stats["batch-q1"].shed:
        fail(f"(c) sheds: {{t: st.shed for t, st in report.stats.items()}}")
    if solo <= 0:
        fail("(c) no hedged solo dispatch for the interactive tenant")
    if any(v is None for v in values.values()):
        fail(f"(c) a serving rule read no value: {values}")
    shares = {t: row.get("bytes") for t, row in insights.serving()["tenants"].items()
              if t in report.stats}
    if not all(shares.values()):
        fail(f"(c) insights.serving() byte shares: {shares}")
    say(f"[tenants] (c) {len(reqs)} requests, {TENANT_THREADS} threads, closed loop: served "
        f"{report.served}, shed {report.shed} (all ShedRejection, all low-quota), every served result "
        f"equal to run_serial byte for byte ({checked} Q1-shaped answers also to numpy); wall "
        f"{run_s:.2f} s ({report.aggregate_qps()} served/s), run_serial {serial_s:.2f} s; hedged solo "
        f"dispatches {solo}; rules serving-p99-breach {values['serving-p99-breach']}, tenant-saturation "
        f"{values['tenant-saturation']}, serving-p99-pressure {values['serving-p99-pressure']}; "
        f"byte shares {shares}  [{card}]")
    for tenant, row in tenant_rows.items():
        say(f"[tenants] (c) {tenant}: served {row['served']}, shed {row['shed']}, queue p50/p99 "
            f"{row['queue_p50_ms']}/{row['queue_p99_ms']} ms, execute p50/p99 {row['execute_p50_ms']}/"
            f"{row['execute_p99_ms']} ms, end-to-end p99 {row['total_p99_ms']} ms against "
            f"{row['p99_budget_ms']} ms ({row['latency_class']})  [{card}]")
    # the hedge's fault site: the solo rung degrades to the window, same bytes
    inter = [r for r in reqs if r.tenant == "interactive"][:6]
    want = [tq.execute(r.expr, cache=None).serialize() for r in inter]
    with fusion.FusionExecutor(cache=None) as ex:
        with faults.inject("query.hedge", every=1) as inj:
            got = [ex.submit(r.expr, tenant="interactive").result(timeout=120).serialize() for r in inter]
        batches = ex.batches
    if got != want or inj.fired < 1 or batches < len(inter):
        fail(f"(c) query.hedge faults: fired {inj.fired}, windows {batches}, bytes equal {got == want}")
    ladder.LADDER.reset()
    # admission's fault site: a quota that sheds admits, degraded
    c = serve.AdmissionController(max_inflight=4, queue_limit=0, clock=lambda: 0.0)
    for _ in range(3):
        c.admit("low-quota", now=0.0, wait=False).release()
    shed = c.admit("low-quota", now=0.0, wait=False)
    with faults.inject("serve.admit", every=1) as inj2:
        opened = c.admit("low-quota", now=0.0, wait=False)
    admitted = (opened.admitted, opened.degraded)
    opened.release()
    if shed.admitted or admitted != (True, True) or inj2.fired != 1:
        fail(f"(c) serve.admit: without the fault {shed.verdict}, with it (admitted, degraded) {admitted}")
    say(f"[tenants] (c) {inj.fired} query.hedge faults: {len(inter)} interactive requests through the "
        f"window ({batches} windows), bytes equal; a serve.admit fault admitted a request the quota "
        f"shed, degraded; phase (c) {time.perf_counter() - t0:.1f} s  [{card}]")

    # (d) the actuations: refit, autotune, a red bundle, the state round trip
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="rb_tenants_") as sink:
        prev_sink = artifacts.artifact_dir()
        artifacts.configure(dir=sink)
        try:
            drift_rule = next(r for r in health.DEFAULT_RULES if r.name == "costmodel-drift")
            s = sentinel.Sentinel(rules=(drift_rule,), clock=lambda: 0.0)
            tick_s, reps = [], []
            for k in range(2):  # fire_after = 2: the second tick actuates
                snap_k = health.snapshot(prev_sums=dict(s._prev_sums), now=2e6 + k, refresh_hbm=False)
                snap_k.drift = {"or/columnar-cpu/run": 8.0}  # a seeded cell, critical
                t1 = time.perf_counter()
                reps.append(s.tick(now=2e6 + k, snap=snap_k))
                tick_s.append(time.perf_counter() - t1)
            refit = [a for r in reps for a in r["actuated"] if a["kind"] == "refit"]
            bundles = [a for r in reps for a in r["actuated"] if a["kind"] == "bundle"]
            if len(refit) != 1 or "error" in refit[0] or sorted(refit[0]["authorities"]) != cost.names():
                fail(f"(d) the seeded costmodel-drift refit: {refit}")
            if len(bundles) != 1 or "error" in bundles[0]:
                fail(f"(d) the red episode's bundle: {bundles}")
            bundle.read_manifest(bundles[0]["path"], verify=True)
            cal = json.loads(open(os.path.join(bundles[0]["path"], "calibration.json")).read())
            if sorted(cal["authorities"]) != cost.names() or len(cal["authorities"]) != 8:
                fail(f"(d) the bundle's calibration.json holds {sorted(cal['authorities'])}")
            say(f"[tenants] (d) seeded costmodel-drift (8.0): red on tick 2, refit_all with a report per "
                f"authority ({', '.join(f'{n}: {sorted(a['moved']) or a.get('refused') or []}' for n, a in refit[0]['authorities'].items())}), "
                f"no error; the ticks {tick_s[0] * 1e3:.2f} / {tick_s[1] * 1e3:.2f} ms (the second with the "
                f"refit and the bundle); the bundle's calibration.json lists the {len(cal['authorities'])} "
                f"authorities  [{card}]")
        finally:
            artifacts.configure(dir=prev_sink)
    # serving-p99-pressure -> autotune_window: shrink, then regrow
    pressure = next(r for r in health.DEFAULT_RULES if r.name == "serving-p99-pressure")
    slo.TENANTS.declare("tight", quota_qps=1e6, latency_class="interactive", p99_budget_ms=0.3)
    slo.record("tight", "ok", execute_s=0.0001)  # the series exists before the arm
    s = sentinel.Sentinel(rules=(pressure,), clock=lambda: 0.0, autotune_cooldown_s=30.0)
    s._actuate_bundle = lambda now, tick, rules, evals: {"tick": tick, "kind": "bundle"}
    base_window = fusion.config.window_base
    windows, tunes = [], []
    for k, (now, budget, slow_s) in enumerate(((3e6, None, None), (3e6 + 1, None, 0.02),
                                               (3e6 + 2, None, 0.02), (3e6 + 40, 100.0, 2.0),
                                               (3e6 + 41, 100.0, 2.0))):
        if budget is not None:
            slo.TENANTS.declare("tight", quota_qps=1e6, latency_class="interactive", p99_budget_ms=budget)
        for _ in range(10 if slow_s else 0):
            slo.record("tight", "ok", execute_s=slow_s)
        rep_k = s.tick(now=now, snap=health.snapshot(prev_sums=dict(s._prev_sums), now=now,
                                                    refresh_hbm=False))
        tunes += [a for a in rep_k["actuated"] if a["kind"] == "autotune"]
        windows.append(fusion.config.window)
    verdicts = [a.get("verdict") for a in tunes]
    if any("error" in a for a in tunes) or "shrink" not in verdicts or "regrow" not in verdicts or \
            fusion.config.window != base_window:
        fail(f"(d) serving-p99-pressure autotunes {tunes}, windows {windows}")
    say(f"[tenants] (d) serving-p99-pressure: autotune_window {verdicts} "
        f"({', '.join(f'{a['window_from']}->{a['window_to']} at {a['budget_ms']} ms' for a in tunes)}); "
        f"the window over the ticks {windows}, back at its base {base_window}  [{card}]")
    # the cost state on the card: a round trip, and a host's state refused.
    # Loading a state with a gate pushes it into the dispatcher (on the
    # card), so the views are compared without the breakeven view's copy
    # of min_device_containers, which is checked against the gate apart
    def cal_view():
        view = cost.calibration_state()
        view["authorities"]["device-breakeven"]["curves"].pop("config_min_device_containers")
        return view

    with tempfile.TemporaryDirectory(prefix="rb_cost_") as d:
        path = os.path.join(d, "cost.json")
        before = cal_view()
        cost.save_state(path)
        doc = json.loads(open(path).read())
        stamps = {n: doc["authorities"][n].get("backend") for n in ("device-breakeven", "pack-residency")}
        cost.reset_all()
        verdicts = cost.load_state(path)
        after = cal_view()
        if not all(verdicts.values()) and [n for n, v in verdicts.items() if not v] != ["columnar-cutoff"]:
            fail(f"(d) load_state on the card: {verdicts}")
        if after != before or stamps != {"device-breakeven": "cuda", "pack-residency": "cuda"}:
            fail(f"(d) the round trip changed the calibration state (stamps {stamps})")
        loaded_gate = breakeven.MODEL.gate_rows
        if loaded_gate is not None and aggregation.config.min_device_containers != loaded_gate:
            fail(f"(d) load_state on the card did not push the gate {loaded_gate}")
        for n in stamps:
            doc["authorities"][n]["backend"] = "cpu"
        with open(path, "w") as f:
            json.dump(doc, f)
        host = cost.load_state(path)
        if host["device-breakeven"] or host["pack-residency"] or cal_view() != before:
            fail(f"(d) a 'cpu'-stamped state was not refused: {host}")
    say(f"[tenants] (d) save_state / load_state on the card: stamps {stamps}, verdicts {verdicts}, "
        f"calibration_state equal after the round trip, the loaded gate {loaded_gate} pushed into "
        f"min_device_containers ({aggregation.config.min_device_containers}); the 'cpu'-stamped breakeven and residency "
        f"states refused ({ {n: host[n] for n in stamps} }); (d) {time.perf_counter() - t0:.1f} s  [{card}]")

    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    say(f"[tenants] launches over phase 18's path: {launches}  [{card}]")
    for name in TENANT_KERNELS:  # a kernel's count summed over its layouts
        if not sum(v for k, v in launches.items() if k == name or k.startswith(name + "[")):
            fail(f"kernel {name} was not launched on phase 18's path")
    slo.reset()
    serve.CONTROLLER.reset()
    outcomes.reset()
    decisions.LOG.clear()
    ladder.LADDER.reset()
    store.PACK_CACHE.close()
    tq.DEFAULT_CACHE.clear()
    _restore_authorities("[tenants]", authorities)
    say(f"[tenants] phase 18 took {time.perf_counter() - t_phase:.1f} s  [{card}]")
    return launches


EPOCH_REQUESTS = 200  # (a): the read-write schedule
EPOCH_THREADS = 8
EPOCH_LANE_ROUNDS = 3  # (a): flips between readers pinned through the overlap lane
EPOCH_LANE_QUERIES = 4  # queries a pinned reader runs through the lane: half Q1-shaped
# the whole script's cut of (a): phase 19 took 131.5 s inside it and the
# script 942.1 s (past its 900 s); at 80 requests and 2 lane flips 72.4 s
# and 901.1 s; --only epochs keeps the sizes above
WHOLE_EPOCH_SIZES = (40, 1, 2)
EPOCH_KERNELS = ("rb_expand_rows", "rb_group_reduce", "rb_popcount_rows", "rb_threshold")
# cycles of torch.cuda._sleep ahead of a reader's device copy that is still in
# flight when its pin is released (about half a second: longer than a flip's
# host work, so the patch would land first were it not ordered after the copy)
IN_FLIGHT_SLEEP_CYCLES = 1_000_000_000


def _stage_row(hist, stages):
    """``{stage: (count, p50 ms, p99 ms)}`` of a latency histogram's series."""
    out = {}
    for st in stages:
        s = hist.series().get((st,))
        if s is not None:
            out[st] = (s["count"], round(hist._quantile_of_state(s, 0.5) * 1e3, 3),
                       round(hist._quantile_of_state(s, 0.99) * 1e3, 3))
    return out


def _counted(into: dict):
    """A context manager that adds the kernel launches made inside its block
    to ``into``: a phase's own path counted segment by segment, with the
    oracle and the checks run between the segments left out."""
    import contextlib

    from roaringbitmap_tpu_torch.ops import kernels as K

    @contextlib.contextmanager
    def segment():
        snap = dict(K.LAUNCHES)
        try:
            yield
        finally:
            for k, v in dict(K.LAUNCHES).items():
                if v != snap.get(k, 0):
                    into[k] = into.get(k, 0) + v - snap.get(k, 0)

    return segment()


def _wide_ors(sets, device):
    """The serialized device OR of each working set (a list of bitmaps)."""
    from roaringbitmap_tpu_torch import FastAggregation

    return [FastAggregation.or_(*ws, mode="device", device=device).serialize() for ws in sets]


def phase_epochs(base, bitmaps, card: str,
                 sizes=(EPOCH_REQUESTS, EPOCH_LANE_ROUNDS, EPOCH_LANE_QUERIES)):
    """Phase 19: the serving write path and the durable tier on the card —
    (a) ingest and epoch flips under the load harness with a writer tenant,
    and flips between readers pinned through the overlap lane, every
    result equal to the epoch-replay oracle; (b) a forced maintenance pass;
    (c) atomic persists, a fault at each of the five crash points and a
    torn artifact; (d) recovery, the readmit from the map and the mapped
    demotion rung. ``sizes``: the schedule's requests, the lane rounds and
    the queries a lane reader runs. Returns the launch counts of the
    phase's path: its segments only, without the oracle's and the checks'
    launches between them."""
    import shutil
    import tempfile
    import threading

    from roaringbitmap_tpu_torch import durable, insights, serve
    from roaringbitmap_tpu_torch import observe as tobs
    from roaringbitmap_tpu_torch import query as tq
    from roaringbitmap_tpu_torch.cost import residency
    from roaringbitmap_tpu_torch.observe import REGISTRY, decisions, outcomes, structure
    from roaringbitmap_tpu_torch.ops import kernels as K
    from roaringbitmap_tpu_torch.parallel import aggregation, overlap, store
    from roaringbitmap_tpu_torch.robust import faults, ladder
    from roaringbitmap_tpu_torch.robust.errors import TransientDeviceError
    from roaringbitmap_tpu_torch.serve import epochs, ingest, maintain, slo

    t_phase = time.perf_counter()
    authorities = _authority_snapshot()
    n_requests, lane_rounds, lane_queries = sizes
    nb = len(base)
    device = aggregation.config.device
    if (device, aggregation.config.mode) != ("cuda", "auto"):
        fail(f"aggregation config is {device}/{aggregation.config.mode}, expected cuda/auto")
    outcomes.reset()
    decisions.LOG.clear()
    ladder.LADDER.reset()
    slo.reset()
    structure.LEDGER.reset()
    maintain.reset()
    store.PACK_CACHE.close()
    tq.DEFAULT_CACHE.clear()
    overlap.LANE.configure("on")
    K.reset_launches()
    on_path = {}  # the launches of phase 19's own path: every `with _counted(on_path)` block

    # (a) ingest and flips: an epoch store over a clone of the corpus, the
    # oracle's clone beside it (both made before any write)
    t0 = time.perf_counter()
    corpus = [b.clone() for b in bitmaps]
    clone = [b.clone() for b in bitmaps]
    clone_s = time.perf_counter() - t0
    idx_sets = {name: [i for i in range(len(corpus)) if lo <= i % nb < hi]
                for name, (lo, hi) in zip("ABC", Q1_THIRDS)}
    idx_sets["all"] = list(range(len(corpus)))
    es = serve.EpochStore(corpus)
    t0 = time.perf_counter()
    pinned = [[corpus[i] for i in idx] for idx in idx_sets.values()]
    for idx, ws in zip(idx_sets.values(), pinned):
        es.register_working_set(idx)
        # resident and pinned (the oracle's packs must not evict them), rows
        # on the card
        store.PACK_CACHE.pin_packed(ws, device=device)
        _wide_ors([ws], device)
    warm_s = time.perf_counter() - t0
    if store.PACK_CACHE.stats()["pinned"] != len(pinned):
        fail(f"(a) pinned entries {store.PACK_CACHE.stats()['pinned']}, expected {len(pinned)}")
    n_heads = max(1, min(10, len(corpus) // Q1_HEAD))
    cores = {}

    def q1_mix(rng, cor, shared):
        core = cores.get(id(cor[0]))
        if core is None:
            A, B, C = ([cor[i] for i in idx_sets[n]] for n in "ABC")
            core = cores[id(cor[0])] = (tq.Q.or_(*A) & tq.Q.or_(*B)) - tq.Q.or_(*C)
        j = int(rng.integers(0, n_heads))
        k = int(rng.integers(2, 4))
        return core | tq.Q.threshold(k, *cor[j * Q1_HEAD:(j + 1) * Q1_HEAD])

    profiles = [
        serve.TenantProfile("interactive", weight=2.0, quota_qps=1e6, latency_class="interactive"),
        serve.TenantProfile("batch-q1", weight=1.0, quota_qps=1e6, mix=q1_mix),
        serve.TenantProfile("writer", weight=1.0, quota_qps=1e6, writes=1.0),
    ]
    reqs = serve.build_requests(corpus, profiles, n_requests, seed=SEED + 19)
    clone_reqs = serve.build_requests(clone, profiles, n_requests, seed=SEED + 19)
    n_writes = sum(r.kind == "write" for r in reqs)
    adm = serve.AdmissionController(max_inflight=2 * EPOCH_THREADS, queue_limit=0)
    harness = serve.LoadHarness(corpus, profiles, threads=EPOCH_THREADS, admission=adm,
                                epoch_store=es)
    t1 = time.perf_counter()
    with _counted(on_path):
        report = harness.run(reqs)
    run_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    oracle = serve.LoadHarness.run_serial_epochs(clone_reqs, clone, report)
    serial_s = time.perf_counter() - t1
    bad = [pos for pos, (g, w) in enumerate(zip(report.results, oracle))
           if (g != w if isinstance(g, tuple) else
               isinstance(g, serve.ShedRejection) or g.serialize() != w.serialize())]
    if bad or report.shed:
        fail(f"(a) {len(bad)} results differ from run_serial_epochs (first at {bad[:1]}), "
             f"{report.shed} shed")
    lineage = [r for r in es.lineage() if r["outcome"] == "flipped"]
    full = [r["epoch"] for r in lineage if r["delta"]["full_repacks"]]
    if not lineage or full or es.log.depth():
        fail(f"(a) flips {len(lineage)}, flips with a full repack {full}, log depth {es.log.depth()}")
    # flips between readers pinned through the overlap lane: each reader's
    # result against the oracle of its own epoch
    t1 = time.perf_counter()
    rng = np.random.default_rng(SEED + 190)
    abc = idx_sets["A"] + idx_sets["B"] + idx_sets["C"]
    lane_checked = 0
    for rnd in range(lane_rounds + 1):
        batch = None
        if rnd < lane_rounds:
            batch = {}
            for i in rng.choice(abc, 3, replace=False).tolist():
                keys = corpus[i].high_low_container.keys
                hb = int(keys[int(rng.integers(0, len(keys)))])
                batch[i] = ((hb << 16) | rng.integers(0, 1 << 16, 40)).astype(np.int64)
        heads = [int(h) for h in rng.integers(0, n_heads, lane_queries // 2)]
        # fresh subsets holding the round's bitmaps: packs the lane stages
        # on its own stream while the flip waits on the pin
        touched = sorted(batch) if batch else []
        subsets = [sorted(set(touched) | set(rng.choice(len(corpus), 300, replace=False).tolist()))
                   for _ in range(lane_queries - len(heads))]

        def exprs(cor, heads=heads, subsets=subsets):
            out = [q1_mix(np.random.default_rng(h), cor, None) for h in heads]
            for sub in subsets:
                half = len(sub) // 2
                out.append(tq.Q.or_(*[cor[i] for i in sub[:half]])
                           | tq.Q.and_(tq.Q.or_(*[cor[i] for i in sub[half:]]), cor[sub[0]]))
            return out
        flipper = None
        with _counted(on_path):
            with es.reader() as pin:
                if batch is not None:
                    es.submit("writer", batch)
                    flipper = threading.Thread(target=es.flip, kwargs={"reason": "lane"}, daemon=True)
                    flipper.start()
                got = [r.serialize() for r in tq.execute_pipelined(exprs(corpus), cache=None)]
                epoch = pin.epoch
            if flipper is not None:
                flipper.join(120.0)
        if flipper is not None and flipper.is_alive():
            fail("(a) a flip behind a pinned lane reader did not finish")
        want = [tq.execute(e, cache=None).serialize() for e in exprs(clone)]
        if got != want:
            fail(f"(a) a lane reader pinned to epoch {epoch} differs from its epoch's oracle")
        lane_checked += len(got)
        if batch is not None:
            ingest.apply_batches(clone, [ingest.MutationBatch("writer", batch)])
    overlap.LANE.drain()
    lane_s = time.perf_counter() - t1
    lane_stats = overlap.LANE.stats()
    # a reader's device read still in flight when its pin is released: a
    # copy of the whole set's resident rows queued on a side stream behind a
    # device sleep; the flip may patch those rows only after the copy ran
    t1 = time.perf_counter()
    pg = store.packed_for(pinned[-1], device=device)
    rows_before = pg.device_words.clone()
    i = int(rng.choice(abc))
    keys = corpus[i].high_low_container.keys
    batch = {i: ((int(keys[0]) << 16) | rng.integers(0, 1 << 16, 64)).astype(np.int64)}
    es.submit("writer", batch)
    side = torch.cuda.Stream()
    with _counted(on_path):
        with es.reader():
            with torch.cuda.stream(side):
                torch.cuda._sleep(IN_FLIGHT_SLEEP_CYCLES)
                rows_seen = pg.device_words.clone()
        inflight = es.flip(reason="in-flight")
    torch.cuda.synchronize()
    ingest.apply_batches(clone, [ingest.MutationBatch("writer", batch)])
    patched = not torch.equal(pg.device_words, rows_before)
    held = torch.equal(rows_seen, rows_before)
    if inflight["outcome"] != "flipped" or not inflight["delta"]["delta_rows"] or not patched or not held:
        fail(f"(a) a flip behind a device read still in flight: {inflight['outcome']}, delta "
             f"{inflight.get('delta')}, rows patched {patched}, the in-flight copy holds its "
             f"epoch's rows {held}")
    inflight_s = time.perf_counter() - t1
    del pg, rows_before, rows_seen
    lineage = [r for r in es.lineage() if r["outcome"] == "flipped"]
    full = [r["epoch"] for r in lineage if r["delta"]["full_repacks"]]
    if full:
        fail(f"(a) flips with a full repack: {full}")
    if [b.serialize() for b in corpus[:200]] != [b.serialize() for b in clone[:200]]:
        fail("(a) the epoch store's corpus and the oracle's clone diverged")
    stages = _stage_row(epochs.FLIP_STAGE_SECONDS, epochs.FLIP_STAGES)
    fresh = insights.epochs()["freshness"]
    rows = report.tenant_rows()
    say(f"[epochs] (a) {len(reqs)} requests ({n_writes} writes), {EPOCH_THREADS} threads, overlap lane on: "
        f"served {report.served}, shed {report.shed}, wall {run_s:.2f} s, run_serial_epochs {serial_s:.2f} s, "
        f"every result equal to the epoch-replay oracle; clones {clone_s:.1f} s, warm-up of A, B, C and "
        f"all {warm_s:.1f} s  [{card}]")
    say(f"[epochs] (a) {lane_rounds} flips between readers pinned through the lane: {lane_checked} "
        f"results (Q1-shaped and over fresh subsets the lane staged), each equal to its epoch's "
        f"oracle; lane {lane_stats}; {lane_s:.1f} s  [{card}]")
    say(f"[epochs] (a) a flip behind a reader's device copy of the whole set's rows, still in flight on "
        f"a side stream when its pin was released: the copy holds its epoch's rows, the flip patched "
        f"{inflight['delta']['delta_rows']} rows after it, flip wall {inflight['wall_s'] * 1e3:.1f} ms; "
        f"{inflight_s:.1f} s  [{card}]")
    say(f"[epochs] (a) flips {len(lineage)} (epoch {es.current()}), every one on the delta route; delta "
        f"records {[r['delta'] for r in lineage]}  [{card}]")
    say(f"[epochs] (a) flip stages (count, p50 ms, p99 ms) {stages}; freshness "
        f"{ {t: (f['count'], round(f['p50'] * 1e3, 3), round(f['p99'] * 1e3, 3)) for t, f in fresh.items()} } "
        f"(count, p50 ms, p99 ms)  [{card}]")
    for tenant in ("interactive", "batch-q1", "writer"):
        row = rows[tenant]
        say(f"[epochs] (a) {tenant}: served {row['served']}, queue p99 {row['queue_p99_ms']} ms, "
            f"execute p50/p99 {row['execute_p50_ms']}/{row['execute_p99_ms']} ms, end-to-end p99 "
            f"{row['total_p99_ms']} ms  [{card}]")
    del clone, clone_reqs, oracle, report

    # (b) a forced maintenance pass over the whole corpus
    t0 = time.perf_counter()
    sets = [[corpus[i] for i in idx] for idx in idx_sets.values()]
    before = _wide_ors(sets, device)
    structure.LEDGER.watch("census", corpus)
    drift0 = structure.LEDGER.refresh()
    t1 = time.perf_counter()
    with _counted(on_path):
        rec = maintain.run_pass(es, reason="chip", force=True)
    pass_s = time.perf_counter() - t1
    after = _wide_ors(sets, device)
    drift1 = structure.LEDGER.stats()
    if rec["outcome"] != "compacted" or rec["anomalies"] or after != before:
        fail(f"(b) pass {rec['outcome']}, anomalies {rec.get('anomalies')}, "
             f"wide ORs unchanged {after == before}")
    if not drift1["drift_ratio"] < drift0["drift_ratio"] or rec["flip"]["delta"]["full_repacks"]:
        fail(f"(b) drift {drift0['drift_ratio']} -> {drift1['drift_ratio']}, flip delta {rec['flip']['delta']}")
    say(f"[epochs] (b) forced maintenance pass: rewritten keys {rec['rewritten_keys']}, reclaimed "
        f"{rec['reclaimed_bytes']} bytes, audited {rec['audited']}, anomalies 0; drift ratio "
        f"{drift0['drift_ratio']} -> {drift1['drift_ratio']}; the wide OR of A, B, C and all unchanged "
        f"bit for bit; its flip {rec['flip']['delta']}; pass {pass_s:.2f} s, phase (b) "
        f"{time.perf_counter() - t0:.1f} s  [{card}]")

    # (c) persists, the five crash points and a torn artifact
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="rb_epochs_")
    rc = None
    try:
        ds = durable.DurableStore(root, keep=3)
        serial = REGISTRY.get(tobs.SERIAL_BYTES_TOTAL)
        ser0 = serial.get(("serialize",))
        t1 = time.perf_counter()
        with _counted(on_path):
            first = ds.persist(es, reason="chip")
        persist_s = time.perf_counter() - t1
        ser_moved = serial.get(("serialize",)) - ser0
        if first["outcome"] != "persisted":
            fail(f"(c) the first persist: {first}")
        # the pre-crash result: the corpus's wide OR at the epoch persisted first
        complete, first_or = first["epoch"], _wide_ors([corpus], device)[0]
        pstages = _stage_row(durable.store.PERSIST_STAGE_SECONDS, durable.PERSIST_STAGES)
        say(f"[epochs] (c) persist of epoch {complete}: artifact {first['artifact_bytes']} bytes, "
            f"{first['n_bitmaps']} bitmaps, wall {persist_s:.2f} s, stages (count, p50 ms, p99 ms) "
            f"{pstages}; rb_tpu_serial_bytes_total{{serialize}} +{ser_moved}  [{card}]")
        rng = np.random.default_rng(SEED + 191)
        crash = []
        for point in range(1, 6):
            i = int(rng.integers(0, len(corpus)))
            keys = corpus[i].high_low_container.keys
            es.submit("writer", {i: [(int(keys[0]) << 16) | int(rng.integers(0, 1 << 16))]})
            with _counted(on_path):
                flip = es.flip(reason=f"crash-{point}")
            if flip["outcome"] != "flipped" or flip["delta"]["full_repacks"]:
                fail(f"(c) the flip before crash point {point}: {flip}")
            faults.clear()  # the per-site hit counter restarts: after= counts this persist's hits
            with _counted(on_path), faults.inject("durable.persist", TransientDeviceError,
                                               after=point - 1) as inj:
                rec = ds.persist(es, reason=f"crash-{point}")
            if point == 5:  # after the rename: the new epoch is on disk
                complete = es.current()
            with _counted(on_path):
                rc = durable.recover(root)
            found = None if rc is None else rc.epoch
            if rc is not None:
                rc.close()
                rc = None
            crash.append((point, rec["outcome"], inj.fired, found))
            if rec["outcome"] != "aborted" or inj.fired != 1 or found != complete:
                fail(f"(c) crash point {point}: persist {rec['outcome']}, fired {inj.fired}, "
                     f"recover found epoch {found}, expected {complete}")
        ladder.LADDER.reset()
        # a torn artifact: the newest corpus file cut in half
        newest = os.path.join(root, durable.store.epoch_dir_name(complete))
        path = os.path.join(newest, durable.store.CORPUS_NAME)
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
        torn0 = REGISTRY.get(tobs.DURABLE_RECOVERY_TOTAL).get(("torn",))
        with _counted(on_path):
            rc = durable.recover(root)
        torn = REGISTRY.get(tobs.DURABLE_RECOVERY_TOTAL).get(("torn",)) - torn0
        if rc is None or rc.epoch != first["epoch"] or torn != 1:
            fail(f"(c) the torn artifact: recover found {None if rc is None else rc.epoch}, "
                 f"torn {torn}")
        say(f"[epochs] (c) a durable.persist fault at each crash point (point, outcome, fired, "
            f"epoch recover found): {crash}; the truncated epoch {complete} skipped as torn, "
            f"recover found epoch {rc.epoch}; phase (c) {time.perf_counter() - t0:.1f} s  [{card}]")

        for ws in pinned:
            store.PACK_CACHE.unpin_packed(ws, device=device)
        if store.PACK_CACHE.stats()["pinned"]:
            fail(f"(c) pins left after unpinning: {store.PACK_CACHE.stats()['pinned']}")

        # (d) recovery: resume, the census wide OR, the readmit, the mapped rung
        t0 = time.perf_counter()
        t1 = time.perf_counter()
        with _counted(on_path):
            resumed = rc.resume_store()
        resume_s = time.perf_counter() - t1
        if resumed.current() != first["epoch"]:
            fail(f"(d) resumed at epoch {resumed.current()}, expected {first['epoch']}")
        with _counted(on_path):  # the recovered corpus's wide OR
            got_or = _wide_ors([resumed.corpus], device)[0]
        del resumed
        if got_or != first_or:
            fail("(d) the recovered corpus's wide OR differs from the pre-crash result")
        t1 = time.perf_counter()
        with _counted(on_path):  # the readmit and its first OR
            rep = rc.readmit()
            mapped = rc.corpus.bitmaps()
            mapped_or = _wide_ors([mapped], device)[0]
        readmit_s = time.perf_counter() - t1
        learned = residency.MODEL.readmit_estimate("agg")
        if mapped_or != first_or or not learned:
            fail(f"(d) the mapped corpus's OR equal {mapped_or == first_or}, readmit_s {learned}")
        # a budget under two working sets: the eviction demotes to the mapped rung
        halves = (mapped[: len(mapped) // 2], mapped[len(mapped) // 2:])
        store.PACK_CACHE.close()
        prev_budget = store.PACK_CACHE.max_bytes
        demote = REGISTRY.get(tobs.DURABLE_DEMOTE_TOTAL)
        mapped0 = demote.get(("mapped",))
        seq0 = decisions.decisions()[-1]["seq"] if decisions.decisions() else 0
        try:
            with _counted(on_path):
                store.packed_for(halves[0], device=device)
            one = store.PACK_CACHE.stats()["bytes"]
            store.PACK_CACHE.configure(max_bytes=int(one * 1.5))
            with _counted(on_path):
                store.packed_for(halves[1], device=device)
        finally:
            store.PACK_CACHE.configure(max_bytes=prev_budget)
        evicted = [d for d in decisions.decisions()
                   if d["site"] == "pack_cache.evict" and d["seq"] > seq0]
        moved = demote.get(("mapped",)) - mapped0
        if not moved or not evicted or evicted[-1]["decision"] != "demote-mapped":
            fail(f"(d) mapped demotions {moved}, evictions {[d['decision'] for d in evicted]}")
        store.PACK_CACHE.close()
        del mapped, halves
        rc.close()
        rc = None
        say(f"[epochs] (d) recover -> resume_store ({len(corpus)} copies, {resume_s:.2f} s) -> the census wide "
            f"OR equal to the pre-crash result; readmit of the whole set from the map "
            f"{rep['wall_s'] * 1e3:.1f} ms (pack), with its first OR {readmit_s:.2f} s, equal; learned "
            f"readmit_s[agg] {learned:.6f} s; under a {int(one * 1.5)}-byte budget an eviction demoted to "
            f"the mapped rung ({moved} demotions, decision {evicted[-1]['decision']}, est_us "
            f"{evicted[-1]['inputs'].get('est_us')}); recovery closed; phase (d) "
            f"{time.perf_counter() - t0:.1f} s  [{card}]")
    finally:
        if rc is not None:
            store.PACK_CACHE.close()
            rc.close()
        store.set_demotion_probe(None)
        shutil.rmtree(root, ignore_errors=True)

    torch.cuda.synchronize()
    launches = {k: on_path.get(k, 0) for k in dict(K.LAUNCHES)}
    say(f"[epochs] launches over phase 19's path (its segments only): {launches}; with the oracle's and "
        f"the checks' between them: {dict(K.LAUNCHES)}  [{card}]")
    for name in EPOCH_KERNELS:  # a kernel's count summed over its layouts
        if not sum(v for k, v in launches.items() if k == name or k.startswith(name + "[")):
            fail(f"kernel {name} was not launched on phase 19's path")
    overlap.LANE.configure("auto")
    structure.LEDGER.reset()
    maintain.reset()
    slo.reset()
    serve.CONTROLLER.reset()
    outcomes.reset()
    decisions.LOG.clear()
    ladder.LADDER.reset()
    store.PACK_CACHE.close()
    tq.DEFAULT_CACHE.clear()
    _restore_authorities("[epochs]", authorities)
    say(f"[epochs] phase 19 took {time.perf_counter() - t_phase:.1f} s  [{card}]")
    return launches


FUZZ_ITERATIONS = 200  # --only fuzz: the campaign's iterations a family, each pass
# the whole script's count: the least at which every kernel of FUZZ_KERNELS
# launches over passes (a) and (b), found on the CPU by counting the plain
# versions' calls (rb_threshold first runs at 16, in (b)'s second iteration
# of query-planner-vs-naive(device); rb_group_reduce[csr] at 3, when
# device-layouts-vs-cpu-engines(or) reaches its segmented-scan set)
WHOLE_FUZZ_ITERATIONS = 16
FUZZ_KERNELS = ("rb_group_reduce[dense]", "rb_group_reduce[csr]", "rb_popcount_rows",
                "rb_expand_rows", "rb_threshold", "rb_oneil_compare[batched]")
FUZZ_FAMILIES = 31  # run_campaign's invariant families
PLANTED_ITERATIONS = 3  # (c): padded, bucketed and segmented-scan sets


def phase_fuzz(card: str, n: int = FUZZ_ITERATIONS):
    """Phase 20: the fuzz campaign on the card. (a) ``run_campaign(n,
    device="cuda")`` as shipped (``mode="auto"``: fuzz-sized sets go to the
    CPU folds except where a family forces the device); (b) the same with
    ``aggregation.config.mode = "device"`` (restored after), so every
    family's aggregations, queries and serving steps run the kernels, and
    the crash family's children run with ``cuda``; (c) a planted fault:
    ``kernels.group_reduce`` swapped for a version that flips one bit of
    one output row, under which ``device-layouts-vs-cpu-engines(or)`` must
    raise ``InvarianceFailure`` whose base64 repro rebuilds the failing
    working set. Counts the launches of (a) and (b) (``launches_fuzz``) and
    fails if a kernel of FUZZ_KERNELS read 0."""
    from roaringbitmap_tpu_torch import fuzz
    from roaringbitmap_tpu_torch.models import bsi
    from roaringbitmap_tpu_torch.ops import kernels as K
    from roaringbitmap_tpu_torch.parallel import aggregation

    t_phase = time.perf_counter()
    config = (aggregation.config.device, aggregation.config.mode, bsi.config.device)
    if config != ("cuda", "auto", "cuda"):
        fail(f"aggregation/BSI config is {config}, expected cuda/auto/cuda")
    launches: dict = {}
    for tag, mode in (("a", "auto"), ("b", "device")):
        walls: dict = {}
        aggregation.config.mode = mode
        t0 = time.perf_counter()
        try:
            with _counted(launches):
                res = fuzz.run_campaign(n, verbose=False, device="cuda", walls=walls)
        finally:
            aggregation.config.mode = "auto"
        wall = time.perf_counter() - t0
        if len(res) != FUZZ_FAMILIES or res["and-distributes-over-or"] != n or not all(
            1 <= v <= n for v in res.values()
        ):
            fail(f"[fuzz] ({tag}) campaign returned {res}")
        for name, ran in res.items():
            say(f"[fuzz] ({tag}) {name}: {ran} iterations, {walls[name]:.3f} s")
        slowest = sorted(walls, key=walls.get, reverse=True)[:3]
        say(f"[fuzz] ({tag}) mode={mode}: {len(res)} families green at n={n} in {wall:.1f} s; "
            "slowest " + ", ".join(f"{k} {walls[k]:.1f} s" for k in slowest) + f"  [{card}]")
    if (aggregation.config.device, aggregation.config.mode, bsi.config.device) != config:
        fail("[fuzz] run_campaign did not restore the aggregation/BSI config")
    missing = [k for k in FUZZ_KERNELS if not launches.get(k)]
    if missing:
        fail(f"[fuzz] no launch of {missing} over (a) and (b): {launches}")
    say(f"[fuzz] launches over (a) and (b): {launches}")

    # (c) the planted bit: the differential on the card must catch it
    plain_reduce = K.group_reduce
    flips = [0]

    def flipped(words, plan, op, row_map=None):
        out = plain_reduce(words, plan, op, row_map=row_map).clone()
        out[0, 0] ^= 1
        flips[0] += 1
        return out

    K.group_reduce = flipped
    caught = None
    try:
        fuzz.verify_layout_invariance("device-layouts-vs-cpu-engines(or)", op="or",
                                      iterations=PLANTED_ITERATIONS, seed=31)
    except fuzz.InvarianceFailure as e:
        caught = e
    finally:
        K.group_reduce = plain_reduce
    if caught is None:
        fail(f"[fuzz] (c) a flipped bit in rb_group_reduce's output ({flips[0]} calls) was not caught")
    rebuilt = [fuzz.reproduce(r).serialize() for r in caught.repro]
    rng = np.random.default_rng(31)
    layouts = ("padded", "bucketed", "segmented-scan")
    match = None
    for i in range(PLANTED_ITERATIONS):
        ws = fuzz.random_working_set(rng, layouts[i % 3])
        if [b.serialize() for b in ws] == rebuilt:
            match = layouts[i % 3]
            break
    if match is None:
        fail("[fuzz] (c) the failure's base64 repro does not rebuild a working set of the seed")
    say(f"[fuzz] (c) planted bit caught after {flips[0]} reduce call(s): "
        f"{str(caught).splitlines()[0]}; repro rebuilds the {match} set ({len(rebuilt)} bitmaps)")
    say(f"[fuzz] phase 20 took {time.perf_counter() - t_phase:.1f} s  [{card}]")
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=["kernels", "paths", "columnar", "serving", "host", "batch", "mapped",
                                       "sixtyfour", "mesh", "observe", "tenants", "epochs", "fuzz"],
                    help="kernels: phases 1-3; paths: phases 1-2 and the timed paths 5, 8 and 6; "
                         "columnar: phases 1-2 and 9; serving: phases 1-2 and 10; host: phases 1-2, 11 "
                         "and 6; batch: phases 1-3 and 12; mapped: phases 1-2, 6, 7 and 13; "
                         "sixtyfour: phases 1-2 and 14; mesh: phases 1-2, 3 (c) and 15; "
                         "observe: phases 1-2, 16 and 17; tenants: phases 1-2 and 18; "
                         "epochs: phases 1-2 and 19; fuzz: phases 1-2 and 20")
    ap.add_argument("--window-pairs", type=int, default=WINDOW_PAIRS,
                    help=f"adjacent pairs in phase 9's window (default {WINDOW_PAIRS})")
    # one rank of phase 15 (b), started by the phase itself
    ap.add_argument("--mesh-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-ref", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    if args.mesh_rank is not None:
        mesh_rank_main(args.mesh_rank, args.mesh_world, args.mesh_port, args.mesh_ref)
        return
    t_start = time.perf_counter()
    card, kind, count = phase_card()
    phase_build()
    if args.only == "paths":
        base, bitmaps, real = build_working_set()
        phase_timing(bitmaps, card)
        phase_query(base, bitmaps, real, card)
        del bitmaps
        phase_bsi(card)
        say(f"[done] {time.perf_counter() - t_start:.1f} s  [{card}]")
        return
    if args.only == "columnar":
        base, bitmaps, _real = build_working_set()
        phase_columnar(base, bitmaps, card, args.window_pairs)
        say(f"[done] {time.perf_counter() - t_start:.1f} s  [{card}]")
        return
    if args.only == "serving":
        base, bitmaps, _real = build_working_set()
        phase_serving(base, bitmaps, card)
        say(f"[done] {time.perf_counter() - t_start:.1f} s  [{card}]")
        return
    if args.only == "host":
        base, bitmaps, _real = build_working_set()
        host = phase_host(base, bitmaps, card)
        del bitmaps
        phase_bsi(card)
        say(f"[done] {time.perf_counter() - t_start:.1f} s  [{card}]")
        say(json.dumps({"host_tier": host}))
        return
    if args.only == "mapped":
        from roaringbitmap_tpu_torch.utils import datasets

        base, _real = datasets.load_or_synthesize("census1881")
        vals, _launches, index, bsi_times = phase_bsi(card)
        phase_range_bitmap(vals)
        phase_mapped(base, index, vals, bsi_times, card)
        say(f"[done] {time.perf_counter() - t_start:.1f} s  [{card}]")
        return
    if args.only == "mesh":
        from roaringbitmap_tpu_torch.utils import datasets

        base, _real = datasets.load_or_synthesize("census1881")
        widths = phase_width_kernels(card)
        index, vals, index64 = _bsi_indexes_for_mesh(card)
        launches_mesh, launches_b = phase_mesh(base, index, vals, index64, card)
        rows = [{"name": name, "launches": launches_b[name.split("@")[0]], "launches_mesh":
                 launches_b[name.split("@")[0]], **t} for name, t in widths.items()]
        say(f"[done] {time.perf_counter() - t_start:.1f} s  [{card}]")
        say(json.dumps({"launches_mesh": launches_mesh, "width_rows": rows}))
        say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
        return
    if args.only == "observe":
        base, bitmaps, real = build_working_set()
        launches_observe = phase_observe(base, bitmaps, real, card)
        launches_observatory = phase_observatory(base, bitmaps, real, card)
        say(f"[done] {time.perf_counter() - t_start:.1f} s  [{card}]")
        say(json.dumps({"launches_observe": launches_observe,
                        "launches_observatory": launches_observatory}))
        say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
        return
    if args.only == "tenants":
        base, bitmaps, real = build_working_set()
        launches_tenants = phase_tenants(base, bitmaps, real, card)
        say(f"[done] {time.perf_counter() - t_start:.1f} s  [{card}]")
        say(json.dumps({"launches_tenants": launches_tenants}))
        say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
        return
    if args.only == "epochs":
        base, bitmaps, _real = build_working_set()
        launches_epochs = phase_epochs(base, bitmaps, card)
        say(f"[done] {time.perf_counter() - t_start:.1f} s  [{card}]")
        say(json.dumps({"launches_epochs": launches_epochs}))
        say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
        return
    if args.only == "fuzz":
        launches_fuzz = phase_fuzz(card)
        say(f"[done] {time.perf_counter() - t_start:.1f} s  [{card}]")
        say(json.dumps({"launches_fuzz": launches_fuzz}))
        say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
        return
    if args.only == "sixtyfour":
        from roaringbitmap_tpu_torch.utils import datasets

        base, _real = datasets.load_or_synthesize("census1881")
        launches_64, _index64 = phase_sixtyfour(base, card)
        say(f"[done] {time.perf_counter() - t_start:.1f} s  [{card}]")
        say(json.dumps({"launches_64": launches_64}))
        say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
        return
    timings = phase_kernels(card)
    timings.update(phase_bsi_kernels(card))
    timings.update(phase_width_kernels(card))
    timings.update(phase_pair_rows(card))
    t0 = time.perf_counter()
    base, bitmaps, real = build_working_set()
    build_s = time.perf_counter() - t0
    timings.update(phase_threshold_kernel(card, bitmaps))
    timings.update(phase_expand_kernel(card, base, bitmaps))
    timings.update(phase_batch_kernels(card, base, bitmaps))
    launches = None  # not counted unless phases 4, 8, 9, 10, 12 and 6 run
    mapped_launches = None  # phase 13's path, counted when it runs
    launches_64 = None  # phase 14's path, counted when it runs
    mesh_launches = None  # phase 15's paths, (a) and (b), counted when it runs
    observe_launches = None  # phase 16's path, counted when it runs
    observatory_launches = None  # phase 17's path, counted when it runs
    tenants_launches = None  # phase 18's path, counted when it runs
    epochs_launches = None  # phase 19's path, counted when it runs
    fuzz_launches = None  # phase 20's campaign, counted when it runs
    host = None
    if args.only == "batch":
        del bitmaps
        batch_launches, pairwise = phase_batch(base, card)
        launches = {name: None for name in timings}
    if args.only is None:
        agg_launches = phase_main(np.random.default_rng(SEED), base, bitmaps, real, build_s)
        phase_timing(bitmaps, card)
        observe_launches = phase_observe(base, bitmaps, real, card)
        observatory_launches = phase_observatory(base, bitmaps, real, card)
        query_launches = phase_query(base, bitmaps, real, card)
        columnar_launches = phase_columnar(base, bitmaps, card, args.window_pairs)
        serving_launches = phase_serving(base, bitmaps, card)
        host = phase_host(base, bitmaps, card)
        tenants_launches = phase_tenants(base, bitmaps, real, card)
        epochs_launches = phase_epochs(base, bitmaps, card, WHOLE_EPOCH_SIZES)
        del bitmaps
        batch_launches, pairwise = phase_batch(base, card)
        from roaringbitmap_tpu_torch.models import bsi as tbsi

        if (tbsi.config.device, tbsi.config.mode) != ("cuda", "auto"):
            fail(f"BSI config is {tbsi.config.device}/{tbsi.config.mode}, expected cuda/auto")
        vals, bsi_launches, index, bsi_times = phase_bsi(card)
        phase_range_bitmap(vals)
        mapped_launches = phase_mapped(base, index, vals, bsi_times, card)
        _cut_bsi64(WHOLE_BSI64_ROWS)
        launches_64, index64 = phase_sixtyfour(base, card)
        mesh_launches = phase_mesh(base, index, vals, index64, card)
        del index, vals, index64
        fuzz_launches = phase_fuzz(card, WHOLE_FUZZ_ITERATIONS)
        # each kernel's count from the path that runs it: the aggregation
        # path for the reduce kernels, the query path for the threshold
        # kernel, the columnar path for the pair kernel, the lane's path
        # (run_pipelined) for the expansion, the BSI path for the O'Neil
        # walk and the masked popcount; the wide reduce is on none
        launches = dict(agg_launches)
        # the W = 1024 rows' path is phase 15 (b), where every kernel runs
        # at that width
        for name in timings:
            if name.endswith("@1024"):
                launches[name] = mesh_launches[1][name.split("@")[0]]
        launches["rb_threshold"] = query_launches["rb_threshold"]
        launches["rb_pair_rows"] = columnar_launches["rb_pair_rows"]
        launches["rb_expand_rows"] = serving_launches["rb_expand_rows"]
        for name in ("rb_oneil_compare", "rb_oneil_compare[batched]",
                     "rb_oneil_compare[batched-deep]", "rb_popcount_rows[masked]",
                     "wide_reduce_cardinality"):
            launches[name] = bsi_launches[name]
    if args.only in (None, "batch"):
        # the batch path (phase 12) for the masked counts and the all-pairs
        # kernel, whose census-scale times come from that phase too
        for name in ("rb_pair_rows[counts]", "rb_pairwise_and_card"):
            launches[name] = batch_launches[name]
        err = max(timings["rb_pairwise_and_card"]["max_abs_err"], pairwise["max_abs_err"])
        timings["rb_pairwise_and_card"].update(pairwise, max_abs_err=err)
    kernels = []
    for name, t in timings.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "roaringbitmap_tpu_torch/csrc/" + (
                "oneil.cu" if name.startswith("rb_oneil")
                else "query.cu" if name == "rb_threshold"
                else "columnar.cu" if name.startswith("rb_pair_rows")
                else "batch.cu" if name == "rb_pairwise_and_card"
                else "expand.cu" if name == "rb_expand_rows" else "reduce.cu"),
            "replaces": t["replaces"],
            "launches": None if launches is None else launches[name],
            "launches_mapped": None if mapped_launches is None else mapped_launches.get(name, 0),
            "launches_64": None if launches_64 is None else launches_64.get(name, 0),
            "launches_mesh": None if mesh_launches is None else (
                mesh_launches[1][name.split("@")[0]] if name.endswith("@1024")
                else mesh_launches[0][name]),
            "launches_observe": None if observe_launches is None else (
                0 if name.endswith("@1024") else observe_launches.get(name, 0)),
            "launches_observatory": None if observatory_launches is None else (
                0 if name.endswith("@1024") else observatory_launches.get(name, 0)),
            "launches_tenants": None if tenants_launches is None else (
                0 if name.endswith("@1024") else tenants_launches.get(name, 0)),
            "launches_epochs": None if epochs_launches is None else (
                0 if name.endswith("@1024") else epochs_launches.get(name, 0)),
            "launches_fuzz": None if fuzz_launches is None else (
                0 if name.endswith("@1024") else fuzz_launches.get(name, 0)),
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t.get("bound_by", "bytes"),
            "library_ms": t.get("library_ms"),
            **({"shape": t["shape"]} if "shape" in t else {}),
        })
    say(f"[done] {time.perf_counter() - t_start:.1f} s  [{card}]")
    if epochs_launches is not None:
        say(json.dumps({"launches_epochs": epochs_launches}))
    if fuzz_launches is not None:
        say(json.dumps({"launches_fuzz": fuzz_launches}))
    if host is not None:
        say(json.dumps({"host_tier": host}))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
