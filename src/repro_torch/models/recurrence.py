"""The time loops of the recurrent mixers, and the dry run's cap on them.

The mLSTM and sLSTM recurrences (prefill and train) and the Mamba train
scan loop over time one step at a time; the train routes loop over
chunks of steps around them. Each loop asks :func:`steps` how many of its
``T`` steps (or chunks) to run, takes their inputs with
:func:`step_inputs`, and joins its outputs with :func:`stack_steps` (or
:func:`cat_chunks`). All of these are the plain loop unless a cap is
installed: then a loop named ``name`` runs ``min(T, cap)`` steps, the
steps it skips standing in as copies of the last one run, and its trip
count is noted, with the loop it runs ``within``.

Only the dry run installs a cap (``launch.dryrun``, through
``launch.op_analysis.analyze_step``): every step of a loop does the same
work, so its counts at one step and at two give every step's exactly
(``analyze_step`` adds ``T - 1`` times the difference, times the trip
counts of the loops it runs within): FLOPs and collectives as a full run
counts them; the ops and bytes of the stand-in steps (a ``narrow``, a
``cat`` of an ``expand``, their gradients) are a constant a loop beside
them. A run with a cap computes nothing a caller should read.
"""

from __future__ import annotations

import threading

import torch

_state = threading.local()


def set_step_caps(caps: dict | None) -> None:
    """Install (or clear, with ``None``) the caps: loop name -> the most
    steps it runs. A loop whose name is not in ``caps`` runs one step.
    The trip counts noted since the last call are cleared."""
    _state.caps = caps
    _state.trips = {}


def noted_trips() -> dict:
    """Loop name -> ``{"trip_count": T, "executions": n, "within": outer
    loop name or None}`` of the loops run under the caps since they were
    installed."""
    return {k: dict(v) for k, v in getattr(_state, "trips", {}).items()}


def steps(name: str, T: int, within: str | None = None) -> int:
    """How many of its ``T`` steps the loop ``name`` runs now; ``within``
    names the loop whose every step runs this one whole."""
    caps = getattr(_state, "caps", None)
    if caps is None:
        return T
    seen = _state.trips.setdefault(
        name, {"trip_count": T, "executions": 0, "within": within})
    if (seen["trip_count"], seen["within"]) != (T, within):
        raise ValueError(f"loop {name!r} runs {T} steps within {within!r} "
                         f"here and {seen['trip_count']} within "
                         f"{seen['within']!r} elsewhere in the step: the "
                         "dry run scales one trip count a loop")
    seen["executions"] += 1
    return min(T, caps.get(name, 1))


def step_inputs(t: torch.Tensor, run: int, dim: int = 1) -> tuple:
    """The first ``run`` steps of ``t`` along ``dim``, one tensor each:
    ``t.unbind(dim)`` when every step runs."""
    if run == t.shape[dim]:
        return t.unbind(dim)
    return t.narrow(dim, 0, run).unbind(dim)


def stack_steps(hs: list, T: int, dim: int = 1) -> torch.Tensor:
    """The per-step outputs ``hs`` stacked on ``dim`` into ``T`` steps,
    the steps not run (under a cap) standing as the last one run."""
    y = torch.stack(hs, dim)
    if len(hs) == T:
        return y
    last = hs[-1].unsqueeze(dim)
    shape = list(last.shape)
    shape[dim] = T - len(hs)
    return torch.cat([y, last.expand(shape)], dim)


def cat_chunks(hs: list, T: int, dim: int = 1) -> torch.Tensor:
    """The per-chunk outputs ``hs`` joined on ``dim`` into ``T`` chunks,
    the chunks not run (under a cap) standing as the last one run."""
    if len(hs) == T:
        return torch.cat(hs, dim)
    return stack_steps(hs, T, dim).flatten(dim, dim + 1)
