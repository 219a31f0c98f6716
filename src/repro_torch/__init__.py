"""PyTorch/CUDA port of the GB-KMV containment-search system (``repro``).

The package mirrors ``repro``'s module paths and never imports ``jax`` or
``repro``. Its kernels are hand-written CUDA C++ for Hopper
(``kernels/csrc``), each with a plain PyTorch version beside it; the
public door is :mod:`repro_torch.api`.
"""
