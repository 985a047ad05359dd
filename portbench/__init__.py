"""The benchmark of lhvi_tpu_torch: one cell of BENCHMARK.json per run.

Every configuration, traffic mix, query kind, judge and metric lives in a
file of its own, found by the name BENCHMARK.json gives it (see
``registry.py``); ``run.py`` is the entry point.
"""
