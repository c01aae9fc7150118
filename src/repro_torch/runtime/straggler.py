"""Straggler detection: per-step EWMA timing with outlier flagging.

A copy of ``repro.runtime.straggler`` (framework-neutral host code); the
port keeps its own so that it imports nothing of the reference. The batch
serving path feeds it the decode loop's step times, so compilation stalls
or host contention show up as flagged steps.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class StepTimeMonitor:
    alpha: float = 0.1           # EWMA smoothing
    threshold: float = 2.0       # flag if step > threshold * ewma
    warmup: int = 5

    def __post_init__(self):
        self.ewma = None
        self.count = 0
        self.flags = 0
        self.history: list[float] = []

    def record(self, dt: float) -> bool:
        """Record one step time; returns True if it's a straggler step."""
        self.history.append(dt)
        self.count += 1
        if self.ewma is None:
            self.ewma = dt
            return False
        is_outlier = (self.count > self.warmup
                      and dt > self.threshold * self.ewma)
        if is_outlier:
            self.flags += 1
        else:
            # outliers don't contaminate the baseline
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_outlier

    def summary(self) -> dict:
        return {"steps": self.count, "ewma": self.ewma,
                "straggler_steps": self.flags}
