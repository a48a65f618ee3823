"""Device meshes and sharding rules of the port (port of
``repro.parallel``): the ``Mesh`` (single-controller, or bound to a
process group for the LM half), the ``Rules`` that resolve logical roles
onto its axes, ``Px`` and the role trees, the counted collectives
(``parallel.collectives``) and ring attention
(``parallel.ring_attention``)."""
from .sharding import (Mesh, Px, REPLICATED, Rules, Sharding, batch_axes,
                       is_axes, is_px, make_mesh, map_axes, pad_to_multiple,
                       rules_for_mesh, split_tree, stack_axes,
                       visible_devices)

__all__ = ["Mesh", "Px", "REPLICATED", "Rules", "Sharding", "batch_axes",
           "is_axes", "is_px", "make_mesh", "map_axes", "pad_to_multiple",
           "rules_for_mesh", "split_tree", "stack_axes", "visible_devices"]
