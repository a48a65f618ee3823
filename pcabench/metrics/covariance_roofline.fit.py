"""covariance_roofline.fit (%): the Gram's bound (``counts.gram_bound_s``:
m d^2 operations at the TF32 tensor rate, the highest of any fp32-operand
path, or X's bytes at the HBM rate where that is longer) over the device
time of one covariance op: the mean ``gram_kernel`` launch the trace holds
in the window plus the mean ``reduce_kernel`` launch where the op splits
the m axis.  Layer: kernel ``csrc/covariance.cu``."""
from pcabench import counts


def read(view):
    if view.trace is None:
        return None
    grams = view.trace.in_window("gram_kernel")
    if not grams:
        return None
    reduces = view.trace.in_window("reduce_kernel")
    t = sum(e.seconds for e in grams) / len(grams)
    if reduces:
        t += sum(e.seconds for e in reduces) / len(reduces)
    layer = view.measured.layer
    return 100.0 * counts.gram_bound_s(layer["m"], layer["d"]) / t
