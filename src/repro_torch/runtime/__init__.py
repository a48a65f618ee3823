"""The trainer's runtime (port of ``repro.runtime``): the step watchdog
and elastic resume."""
from .elastic import pick_mesh, resume_or_init
from .watchdog import STALL_EXIT_CODE, Watchdog

__all__ = ["STALL_EXIT_CODE", "Watchdog", "pick_mesh", "resume_or_init"]
