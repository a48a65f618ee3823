"""mfu.fit (%): the operations the window's fits need
(``counts.fit_flops`` at the dataset's own shape) over the window times
the fp32 peak.  Layer: the whole fit (``core/pca.py`` ``fit_transform``)."""
from pcabench import counts


def read(view):
    m = view.measured
    if not m.layer.get("fits") or m.window_s <= 0:
        return None
    return 100.0 * m.layer["flops"] / (m.window_s * counts.PEAK_FP32)
