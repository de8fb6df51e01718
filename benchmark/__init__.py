"""The benchmark of reflectance_filtering_tpu_torch, the PyTorch and CUDA
port.  ``python3 benchmark/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` runs one cell of ``BENCHMARK.json`` once; see
``run.py``.  Nothing here imports JAX or the JAX package."""
