"""PyTorch/CUDA port of the MANOJAVAM PCA/SVD engine.

A package beside the JAX reference (``repro``) with the same module layout.
It imports ``torch`` and numpy only.  Its three hot-path kernels
(``covariance``, ``jacobi_sweep``, ``mm_engine_matmul``) are hand-written
CUDA C++ for Hopper (``csrc/``), built with ``nvcc`` at first use and bound
with ``ctypes``; each has a plain PyTorch version beside it, which runs for
tensors that lie on the CPU.

Entry points (``core.pca.fit``/``transform``/``fit_transform`` and the
batched solvers in ``serving.solver``) run on the CUDA device unless the
caller asks for the CPU: numpy input goes to ``device="cuda"`` by default,
and a tensor argument keeps its own device.
"""
from .core.pca import (PAPER_CONFIG_ARTIX7, PAPER_CONFIG_VUS, PCAConfig,
                       PCAResult, fit, fit_transform, transform)

__all__ = ["PCAConfig", "PCAResult", "fit", "transform", "fit_transform",
           "PAPER_CONFIG_ARTIX7", "PAPER_CONFIG_VUS"]
