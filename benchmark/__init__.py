"""The benchmark of ray_tpu_torch on one or four NVIDIA H100 cards.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; ``README.md`` says how
cells, configurations, traffic mixes and per-layer metrics are added.
"""
