"""grid_sweep_roofline.fit (%): a grid sweep's bound
(``counts.sweep_bound_s`` at the fit's d: 9 d^3 operations at the fp32
rate, or its bytes at the HBM rate where that is longer) over the mean
device time of the ``sweep_grid_kernel`` launches the trace holds in the
window.  Only the launches the trace holds count, so a lost event does
not bias it.  Layer: kernel ``csrc/jacobi_sweep.cu``
(``sweep_grid_kernel``)."""
from pcabench import counts


def read(view):
    if view.trace is None:
        return None
    sweeps = view.trace.in_window("sweep_grid_kernel")
    if not sweeps:
        return None
    mean = sum(e.seconds for e in sweeps) / len(sweeps)
    return 100.0 * counts.sweep_bound_s(view.measured.layer["d"]) / mean
