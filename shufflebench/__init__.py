"""shufflebench: the benchmark of ``sparkrdma_tpu_torch``.

``python -m shufflebench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line. Configurations, traffic mixes, key distributions and per-layer
metrics are data files and small modules found by name
(``registry.py``).
"""
