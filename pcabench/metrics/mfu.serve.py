"""mfu.serve (%): the operations the requests completed in the window need
at their own sizes, never their buckets' (``counts.request_flops``), over
the window times the fp32 peak.  Layer: the whole pass
(``serving.PCAServer``)."""
from pcabench import counts


def read(view):
    m = view.measured
    if not m.layer.get("flops") or m.window_s <= 0:
        return None
    return 100.0 * m.layer["flops"] / (m.window_s * counts.PEAK_FP32)
