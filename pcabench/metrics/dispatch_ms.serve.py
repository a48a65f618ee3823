"""dispatch_ms.serve (ms): mean host time of a flush's dispatch stage
(stack, pad, solver lookup, staging and launch: ``FlushRecord.dispatch_s``)
over the flushes retired in the window.  Layer: executor
(``serving/sharded.py`` ``LocalExecutor``)."""


def read(view):
    flushes = view.measured.layer.get("flushes") or []
    if not flushes:
        return None
    return 1e3 * sum(f.dispatch_s for f in flushes) / len(flushes)
