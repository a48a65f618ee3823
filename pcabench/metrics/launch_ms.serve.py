"""launch_ms.serve (ms): mean length of the program's ``repro.launch:``
ranges that start in the window: the host's enqueue of a flush's solve
(about 50 sweep launches and the small ones around them), the copy home
and the event after it.  Layer: solvers (``serving/solver.py``,
``core/jacobi.py``)."""
from pcabench import ranges


def read(view):
    if view.trace is None:
        return None
    return ranges.mean_ms(view.trace, ranges.LAUNCH, prefix=True)
