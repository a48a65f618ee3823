"""The port's checkpointer (port of ``repro.checkpoint``)."""
from . import checkpointer
from .checkpointer import all_steps, latest_step, restore, save

__all__ = ["all_steps", "checkpointer", "latest_step", "restore", "save"]
