"""flush_fill.serve (%): live requests over padded slots, summed over the
flushes the engine retired in the window (``FlushRecord.batch_size`` and
``padded_batch``).  Layer: engine (``serving/engine.py``)."""


def read(view):
    flushes = view.measured.layer.get("flushes") or []
    slots = sum(f.padded_batch for f in flushes)
    if not slots:
        return None
    return 100.0 * sum(f.batch_size for f in flushes) / slots
