"""idle_share.serve (%): the share of the traced window in which no kernel,
copy or set ran on the card: one less the union of the device intervals
over the window (overlapping operations count once).  Layer: device."""


def read(view):
    tr = view.trace
    if tr is None or not tr.window or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
