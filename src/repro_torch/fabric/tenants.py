"""Seeded request arrival process (a copy of
``repro.fabric.tenants.ArrivalProcess``) for the serving engine."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """Seeded arrival-gap generator shared by tenants and the serving engine.

    One pure description of the three workload shapes (constant / bursty /
    churn) with two consumers:

    * :meth:`gap` — the *access*-level semantics ``Tenant.gap_after_access``
      delegates to: extra idle time after access ``idx - 1`` completed (the
      cursor has already advanced to ``idx``), plus a restart flag when a
      churn boundary was crossed. Draws come from the caller's rng so the
      event-engine behavior is bit-identical to the pre-factored code.
    * :meth:`arrival_times` / :meth:`arrival_steps` — the *request*-level
      semantics the continuous-batching serving engine consumes
      (:mod:`repro.serving`): absolute arrival times of ``n`` requests
      (request 0 at ``t = 0``, then cumulative gaps), without instantiating
      fabric ``Tenant``s. Deterministic given ``seed``.
    """

    kind: str = "constant"              # constant | bursty | churn
    think_time: float = 0.0
    burst_len: int = 64
    idle_time: float = 200.0            # mean off-period (µs)
    churn_every: int = 0
    churn_downtime: float = 500.0

    def __post_init__(self):
        if self.kind not in ("constant", "bursty", "churn"):
            raise ValueError(f"unknown arrival kind {self.kind!r}; expected "
                             "constant | bursty | churn")

    def gap(self, rng: np.random.Generator, idx: int,
            n_total: int) -> tuple[float, bool]:
        """``(extra idle time before item idx, churn-restart flag)``.

        ``idx`` is the *next* item's index (the cursor after the completed
        access / the arriving request's ordinal); boundary draws only
        happen while ``idx < n_total`` so a finished stream never burns an
        rng draw.
        """
        gap = self.think_time
        restart = False
        if self.kind == "bursty" and idx < n_total \
                and idx % max(1, self.burst_len) == 0:
            gap += float(rng.exponential(self.idle_time))
        if self.kind == "churn" and self.churn_every > 0 \
                and idx < n_total and idx % self.churn_every == 0:
            restart = True
            gap += self.churn_downtime
        return gap, restart

    def arrival_times(self, n: int, seed: int = 0) -> np.ndarray:
        """Absolute arrival times (µs) of ``n`` requests; ``t[0] == 0``."""
        rng = np.random.default_rng(seed)
        times = np.zeros(n, np.float64)
        for i in range(1, n):
            g, _ = self.gap(rng, i, n)
            times[i] = times[i - 1] + g
        return times

    def arrival_steps(self, n: int, seed: int = 0,
                      step_us: float = 1000.0) -> np.ndarray:
        """Arrival times quantized onto the engine's step clock."""
        return np.floor(self.arrival_times(n, seed) / max(step_us, 1e-9)
                        ).astype(np.int64)
