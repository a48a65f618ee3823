"""The port's kernel layer: the hand-written CUDA kernels of the PCA/SVD
hot path (``fused``, ``mm_engine``) and of the standalone registry ops
(``dle``, ``cordic``, ``flash_attention``, ``mamba_scan``), their plain
PyTorch versions (``ref``) and the registry-dispatched ops over both
(``ops``).

``KERNELS`` lists every kernel with its launch count (three kernels serve
``flash_attention``); nothing here builds or loads a kernel until a
wrapper is called on a CUDA tensor.
"""
from .cordic import CORDIC
from .dle import DLE_SCAN
from .flash_attention import FLASH_KERNELS
from .fused import COVARIANCE, JACOBI_SWEEP
from .launch import KernelInfo
from .mamba_scan import MAMBA_SCAN
from .mm_engine import MM_ENGINE

KERNELS = (COVARIANCE, JACOBI_SWEEP, MM_ENGINE, DLE_SCAN, CORDIC,
           *FLASH_KERNELS, MAMBA_SCAN)


def reset_launch_counts() -> None:
    for kernel in KERNELS:
        kernel.launches = 0


def launch_counts() -> dict:
    return {kernel.name: kernel.launches for kernel in KERNELS}


__all__ = ["KERNELS", "KernelInfo", "launch_counts", "reset_launch_counts"]
