"""Shape arithmetic of the reference's ``parallel.sharding`` that code on
one device needs too.  The mesh rules themselves (``Rules``, ``Px``) are
not ported: one card has no mesh."""
from __future__ import annotations


def pad_to_multiple(n: int, multiple: int) -> int:
    """n rounded up to a multiple of ``multiple`` (a copy of the
    reference's ``parallel.sharding.pad_to_multiple``)."""
    return -(-n // multiple) * multiple
