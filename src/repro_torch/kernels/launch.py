"""What every kernel wrapper shares: its record (with the launch count)
and the checks it makes before it hands pointers to a CUDA kernel.

The dry run (``launch.dryrun``) traces the models on tensors of the
``meta`` device, which hold shapes and no data.  The wrappers of the
kernels on its path (``flash_attention``, ``mamba_scan``) take a fake
branch for them (``is_fake``): the same checks and allocations as a
launch, the call's FLOPs and bytes added to the record (``fake_call``),
no launch.  Every other wrapper refuses a meta operand
(``require_cuda``)."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class KernelInfo:
    """One hand-written kernel.  ``launches`` goes up by one each time its
    wrapper launches it on the card, and nowhere else: the plain version
    that a CPU tensor takes does not count.  An op served by several
    kernels (``flash_attention``) has one record for each."""
    name: str        # the registry op it implements, or the kernel's name
                     # where several kernels serve one op
    source: str      # its CUDA source, relative to the repository root
    replaces: str    # the TPU kernel's pallas_call, file:line
    launches: int = 0
    # the dry run's fake branch: calls taken and their FLOPs and bytes
    # (never a launch; ``launches`` does not move)
    fake_calls: int = 0
    fake_flops: float = 0.0
    fake_bytes: float = 0.0

    def fake_call(self, flops: float, n_bytes: float) -> None:
        self.fake_calls += 1
        self.fake_flops += flops
        self.fake_bytes += n_bytes


def is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is one of the dry run's tensors: on the ``meta``
    device, a shape and no data."""
    return t.is_meta


def require_cuda(what: str, *tensors: torch.Tensor,
                 fake_ok: bool = False) -> torch.device:
    """The one CUDA device all ``tensors`` lie on; raises otherwise.
    ``fake_ok``: a wrapper with a fake branch also takes the dry run's
    meta tensors."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" and not (fake_ok and is_fake(t)):
            fake = (" (the dry run's: only flash_attention and mamba_scan "
                    "have a fake branch)" if is_fake(t) else "")
            raise ValueError(
                f"{what}: the CUDA kernel needs CUDA tensors, got one on "
                f"{t.device}{fake}")
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {dev} and {t.device}")
    return dev


def require(cond: bool, what: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")


def copy_bytes(t: torch.Tensor, ld: int, batch_stride: int) -> int:
    """The widest copy (16, 8 or 4 bytes, else one element) that every row
    start of ``t`` is aligned to, for rows ``ld`` and batches
    ``batch_stride`` elements apart: what one cp.async of the GEMM tile
    (``csrc/gemm_tile.cuh``) moves."""
    es = t.element_size()
    for nbytes in (16, 8, 4):
        e = nbytes // es
        if (t.data_ptr() % nbytes == 0 and ld % e == 0
                and batch_stride % e == 0):
            return nbytes
    return es


def copy_width(d: int, elem_bytes: int, widths, tensors) -> int:
    """The first of ``widths`` (elements a copy) that divides d and to
    whose bytes every tensor's base is aligned (rows d elements apart then
    start aligned too); 1 if none."""
    for vec in widths:
        if d % vec == 0 and all(t.data_ptr() % (elem_bytes * vec) == 0
                                for t in tensors):
            return vec
    return 1


def stream(dev: torch.device) -> int:
    """The handle of PyTorch's current stream on ``dev``."""
    return torch.cuda.current_stream(dev).cuda_stream


# the current stream's handle without building a Stream object (a CUDA
# build of PyTorch has it; else through current_stream)
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def raw_stream(index: int) -> int:
    """The handle of PyTorch's current stream on CUDA device ``index``."""
    if _RAW_STREAM is None:
        return torch.cuda.current_stream(index).cuda_stream
    return _RAW_STREAM(index)


def call_on(index: int, fn, *args):
    """``fn(*args)`` with CUDA device ``index`` current: the device context
    is entered only when another device is current."""
    if torch.cuda.current_device() == index:
        return fn(*args)
    with torch.cuda.device(index):
        return fn(*args)
