"""The benchmark of ``roaringbitmap_tpu_torch`` on one NVIDIA H100.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything a cell needs is found by name: the configuration
``configs/<config>.json`` names its maker module in ``configs/``, the
traffic mix ``traffic/<mix>.json`` names its request kind in ``kinds/``,
and each per-layer metric is read by ``metrics/<metric>.py``.
"""
