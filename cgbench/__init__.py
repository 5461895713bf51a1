"""The benchmark of ``cgx_torch``: time to solution on the card.

``python -m cgbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. See
``cgbench/README.md``.
"""
