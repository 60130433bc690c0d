"""The benchmark of the PyTorch/CUDA port, ``zkt_plonk_tpu_torch``: see
``README.md`` and ``BENCHMARK.json`` at the repository root."""
