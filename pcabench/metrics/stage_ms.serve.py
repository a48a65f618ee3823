"""stage_ms.serve (ms): mean length of the program's ``repro.stage``
ranges that start in the window: a flush's staging (the pinned host
buffers, the copy into them, the non-blocking copy to the card), one a
shard.  Layer: executor (``serving/sharded.py`` ``_stage``)."""
from pcabench import ranges


def read(view):
    if view.trace is None:
        return None
    return ranges.mean_ms(view.trace, "repro.stage")
