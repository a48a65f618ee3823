"""What every kernel wrapper shares: its record (with the launch count)
and the checks it makes before it hands pointers to a CUDA kernel."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class KernelInfo:
    """One hand-written kernel.  ``launches`` goes up by one each time its
    wrapper launches it on the card, and nowhere else: the plain version
    that a CPU tensor takes does not count."""
    name: str        # the registry op it implements
    source: str      # its CUDA source, relative to the repository root
    replaces: str    # the TPU kernel's pallas_call, file:line
    launches: int = 0


def require_cuda(what: str, *tensors: torch.Tensor) -> torch.device:
    """The one CUDA device all ``tensors`` lie on; raises otherwise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(
                f"{what}: the CUDA kernel needs CUDA tensors, got one on "
                f"{t.device}")
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {dev} and {t.device}")
    return dev


def require(cond: bool, what: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")


def stream(dev: torch.device) -> int:
    """The handle of PyTorch's current stream on ``dev``."""
    return torch.cuda.current_stream(dev).cuda_stream
