"""queue_ms.serve (ms): mean time a request waited in its bucket queue
before its flush was dispatched (``RequestRecord.queue_s``), over the
requests completed in the window.  Layer: engine (``serving/engine.py``)."""


def read(view):
    waits = view.measured.layer.get("queue_s") or []
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
