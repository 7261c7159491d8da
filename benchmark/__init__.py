"""Benchmark of the PyTorch/CUDA ProPainter nodes on one NVIDIA H100.

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` and prints one JSON line.
"""
