"""Production mesh construction (port of ``repro.launch.mesh``).

Functions, never module-level constants, so importing this module touches
no device.  The single-pod production mesh is 16 x 16 ("data", "model");
multi-pod adds a leading "pod" axis (2 x 16 x 16).  Each raises where the
visible devices are not exactly that many, as ``jax.make_mesh`` does.
"""
from __future__ import annotations

from typing import Optional, Sequence

from ..parallel.sharding import Mesh, make_mesh, visible_devices


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def make_host_mesh(model: int = 1,
                   devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh over ``devices`` (default: every visible
    card), for tests and examples."""
    devs = list(visible_devices() if devices is None else devices)
    n = len(devs)
    if n % model:
        raise ValueError(f"{n} devices do not split into model axes of "
                         f"{model}")
    return make_mesh((n // model, model), ("data", "model"), devs)
