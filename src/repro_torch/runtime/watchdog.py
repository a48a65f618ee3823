"""Step-time watchdog: stall detection + straggler accounting (a copy of
``repro.runtime.watchdog``: plain Python, so the port keeps its own).

At 1000+ node scale the failure modes that matter are (a) a hung collective
(one node died -> every node blocks forever) and (b) chronic stragglers.
The watchdog arms a timer around every step; if a step exceeds
``stall_factor`` x the EWMA step time (plus a floor), the registered
callback fires -- the trainer uses it to flush an emergency checkpoint and
exit with a distinct code the cluster scheduler maps to "restart from last
checkpoint".  Straggler steps (> ``straggler_factor`` x EWMA) are logged
with their step index for post-hoc correlation with host metrics.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional

STALL_EXIT_CODE = 42  # scheduler contract: restart from latest checkpoint


@dataclasses.dataclass
class StragglerRecord:
    step: int
    seconds: float
    ewma: float


class Watchdog:
    def __init__(self, stall_factor: float = 10.0, floor_s: float = 30.0,
                 straggler_factor: float = 2.0,
                 on_stall: Optional[Callable[[], None]] = None):
        self.stall_factor = stall_factor
        self.floor_s = floor_s
        self.straggler_factor = straggler_factor
        self.on_stall = on_stall
        self.ewma: Optional[float] = None
        self.stragglers: List[StragglerRecord] = []
        self._timer: Optional[threading.Timer] = None
        self._t0 = 0.0
        self._step = 0
        self.stalled = False

    # -- per-step protocol ---------------------------------------------------

    def start_step(self, step: int):
        self._step = step
        self._t0 = time.monotonic()
        budget = max(self.floor_s,
                     (self.ewma or self.floor_s) * self.stall_factor)
        self._timer = threading.Timer(budget, self._fire)
        self._timer.daemon = True
        self._timer.start()

    def end_step(self):
        if self._timer:
            self._timer.cancel()
            self._timer = None
        dt = time.monotonic() - self._t0
        if self.ewma is not None and dt > self.straggler_factor * self.ewma:
            self.stragglers.append(StragglerRecord(self._step, dt, self.ewma))
        self.ewma = dt if self.ewma is None else 0.9 * self.ewma + 0.1 * dt
        return dt

    def _fire(self):
        self.stalled = True
        if self.on_stall:
            self.on_stall()

    def summary(self) -> dict:
        return {
            "ewma_step_s": self.ewma,
            "n_stragglers": len(self.stragglers),
            "stragglers": [dataclasses.asdict(s)
                           for s in self.stragglers[-16:]],
        }
