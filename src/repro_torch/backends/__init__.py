"""Backend registry for the port's kernel ops (see ``registry``)."""
from .registry import (BACKENDS, ENV_VAR, available, backends_for,
                       default_backend, describe, register, registered_ops,
                       reset_resolution_counts, resolution_counts, resolve,
                       set_default_backend, use_backend)

__all__ = ["BACKENDS", "ENV_VAR", "available", "backends_for",
           "default_backend", "describe", "register", "registered_ops",
           "reset_resolution_counts", "resolution_counts", "resolve",
           "set_default_backend", "use_backend"]
