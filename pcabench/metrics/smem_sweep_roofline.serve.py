"""smem_sweep_roofline.serve (%): a shared-memory sweep's bound (its padded
problems' 9 n^3 operations each at the fp32 rate, or their bytes at the
HBM rate where that is longer), averaged over the window's
``repro.launch:...:smem`` ranges weighted by their sweeps, over the mean
device time of the ``sweep_smem_kernel`` launches the trace holds in the
window.  Means on both sides, so a launch the profiler lost does not bias
it.  Layer: kernel ``csrc/jacobi_sweep.cu`` (``sweep_smem_kernel``)."""
from pcabench import ranges


def read(view):
    if view.trace is None:
        return None
    return ranges.sweep_roofline(view.trace, "smem", "sweep_smem_kernel")
