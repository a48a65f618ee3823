"""Device meshes and sharding rules of the port (port of
``repro.parallel``): the single-controller ``Mesh``, the ``Rules`` that
resolve logical roles onto its axes, and the shape arithmetic that
single-device code shares with the mesh code."""
from .sharding import (Mesh, REPLICATED, Rules, batch_axes, make_mesh,
                       pad_to_multiple, rules_for_mesh, visible_devices)

__all__ = ["Mesh", "REPLICATED", "Rules", "batch_axes", "make_mesh",
           "pad_to_multiple", "rules_for_mesh", "visible_devices"]
