"""latency_p95_ms.mixed (ms): the 95th percentile of every request of the
window, each from its ``submit`` call until the client loop sees its
result, as ``latency_p95_ms`` takes it; read per layer where that tail
jumps between runs of one code (which rare wide requests wait behind a
lone grid-sweep flush), so that it carries no bound there.  Layer: the
whole pass (``serving.PCAServer``)."""
import math


def read(view):
    v = view.measured.e2e.get("latency_p95_ms")
    if v is None or math.isnan(v):
        return None
    return v
