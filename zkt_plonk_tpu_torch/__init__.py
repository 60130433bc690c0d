"""zkt_plonk_tpu_torch — the PLONK+Plookup prover in PyTorch with CUDA kernels.

A second implementation of ``zkt_plonk_tpu`` for NVIDIA Hopper (H100): the
same limb layout, the same tables and the same proof bytes, with its field,
NTT and elliptic-curve kernels written by hand in CUDA C++ (``csrc/``).
Every entry point takes ``device=`` and defaults to ``"cuda"``; the tests
pass ``device="cpu"``, where each kernel wrapper runs its plain PyTorch
version instead.
"""

__version__ = "0.1.0"
