"""The benchmark of the PyTorch/CUDA port (``repro_torch``): time to a C4.5
tree on the paper's Table 1 data sets.  ``python3 bench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>`` runs one cell once; cells,
configurations, traffic mixes and metrics are named in ``BENCHMARK.json``
and found by name under ``bench/``."""
