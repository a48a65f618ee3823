"""The port's kernel layer: the hand-written CUDA kernels of the PCA/SVD
hot path (``fused``, ``mm_engine``) and of the standalone registry ops
(``dle``, ``cordic``, ``flash_attention``, ``mamba_scan``), their plain
PyTorch versions (``ref``) and the registry-dispatched ops over both
(``ops``).

``KERNELS`` lists every kernel with its launch count (two kernels serve
``jacobi_sweep``, three ``flash_attention`` and two ``mamba_scan``: its
fp32-state and bf16-state instances); nothing here builds
or loads a kernel until a wrapper is called on a CUDA tensor.
"""
from .cordic import CORDIC
from .dle import DLE_SCAN
from .flash_attention import FLASH_KERNELS
from .fused import COVARIANCE, JACOBI_SWEEP, JACOBI_SWEEP_SMEM
from .launch import KernelInfo
from .mamba_scan import MAMBA_SCAN, MAMBA_SCAN_BF16
from .mm_engine import MM_KERNELS

KERNELS = (COVARIANCE, JACOBI_SWEEP, JACOBI_SWEEP_SMEM, *MM_KERNELS, DLE_SCAN, CORDIC,
           *FLASH_KERNELS, MAMBA_SCAN, MAMBA_SCAN_BF16)


def reset_launch_counts() -> None:
    for kernel in KERNELS:
        kernel.launches = 0


def launch_counts() -> dict:
    return {kernel.name: kernel.launches for kernel in KERNELS}


def reset_fake_counts() -> None:
    for kernel in KERNELS:
        kernel.fake_calls, kernel.fake_flops, kernel.fake_bytes = 0, 0.0, 0.0


def fake_counts() -> dict:
    """{kernel: {"calls", "flops", "bytes"}} of the dry run's fake branch,
    for the kernels it took."""
    return {k.name: {"calls": k.fake_calls, "flops": k.fake_flops,
                     "bytes": k.fake_bytes} for k in KERNELS if k.fake_calls}


__all__ = ["KERNELS", "KernelInfo", "fake_counts", "launch_counts",
           "reset_fake_counts", "reset_launch_counts"]
