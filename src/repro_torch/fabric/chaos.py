"""Fault injection for the fabric: chaos specs and deadline adaptation.

A copy of the NumPy ``repro.fabric.chaos`` (the port imports nothing of the
JAX package): :class:`ChaosSpec` describes the four fault axes (DESIGN.md
§9) — per-shard *slowdown* (stragglers), transient per-NIC *budget
degradation*, *node loss* with deterministic page re-homing, and *elastic
tenant grants* that grow and shrink mid-run. The spec is a frozen, hashable
dataclass of plain-int tuples with a JSON round trip.

:func:`compile_chaos` lowers a spec into dense per-step tables; the sharded
consume scan (``repro_torch.paging.sharded_pool``) reads those tables,
never the raw spec, so fault timing is decided in one place.

The deadline estimator is an integer fixed-point EWMA (Q8, alpha = 1/4).
Integer arithmetic is deliberate: ``torch`` floor division on int32 and
Python's ``//`` both round toward -inf, so the estimator carried through
the scan and a Python-int mirror stay bit-identical.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

# Sentinel for "no limit" in budget / grant tables.  Fits int32 with headroom
# for ``INF - demand`` style arithmetic.
INF = 1 << 30

# Q8 fixed point: one step of delay == 256 estimator units.
EST_ONE = 256
# EWMA smoothing alpha = EST_A / EST_D.
EST_A = 1
EST_D = 4


def est_step(est, obs_sum, cnt):
    """One EWMA update from a batch of ``cnt`` landings summing to ``obs_sum``.

    ``est' = est + alpha * (mean_obs - est)`` in Q8 fixed point, evaluated so
    Python ints and int32 tensors produce identical bit patterns (both
    floor).  Caller guarantees ``cnt >= 1``.
    """
    return est + (EST_A * (obs_sum * EST_ONE - cnt * est)) // (EST_D * cnt)


def est_delay(est):
    """Round a Q8 estimate to whole steps, clamped to >= 1."""
    d = (est + EST_ONE // 2) // EST_ONE
    return max(1, d) if isinstance(d, int) else d  # tensor callers clamp


def est_init(n_streams: int, n_shards: int, near: int, far: int) -> np.ndarray:
    """Initial per-(stream, shard) Q8 estimates seeded from the static delays.

    Stream ``s`` is homed on shard ``s % n_shards`` (DESIGN.md §7), so its
    prior is ``near`` for its home NIC and ``far`` everywhere else.
    """
    home = np.arange(n_streams, dtype=np.int64) % max(1, n_shards)
    base = np.where(np.arange(n_shards)[None, :] == home[:, None], near, far)
    return (base * EST_ONE).astype(np.int32)


def rehome_shard(page: int, home0: int, dead: int, n_shards: int) -> int:
    """Deterministic re-home rule: pages on the dead shard move to
    ``alive[page % (n_shards - 1)]`` where ``alive`` is the sorted list of
    surviving shards."""
    if home0 != dead:
        return home0
    alive = [g for g in range(n_shards) if g != dead]
    return alive[page % (n_shards - 1)]


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    """Declarative fault schedule.  All fields are tuples of plain ints so the
    spec is hashable.

    * ``slowdown``: ``(shard, factor, onset, recovery)`` — physical transfer
      time from ``shard`` is multiplied by ``factor`` for steps in
      ``[onset, recovery)``.  Later entries override earlier ones on overlap
      (this is what lets a ramp be written as successive entries).
    * ``degradation``: ``(shard, budget, onset, recovery)`` — the per-NIC
      prefetch budget of ``shard`` is capped at ``budget`` during the window.
    * ``node_loss``: ``(shard, step)`` or ``None`` — at the top of ``step``
      the shard dies: its resident prefetches are invalidated (pollution) and
      its pages are re-homed by :func:`rehome_shard` for all scheduling
      decisions from that step on.  Bytes keep flowing from the original
      placement (the survivor holds a replica), so the data plane is
      unchanged — re-homing is scheduling metadata only.
    * ``grants``: ``(stream, grant, onset, recovery)`` — elastic tenant
      memory: stream's unconsumed-prefetch + in-flight footprint is capped at
      ``grant`` pages during the window; issues beyond it are drops.
    * ``adaptive_deadline``: when true, prefetch *deadlines* come from the
      EWMA estimator instead of the static near/far delay.  Classification
      only: it never changes when bytes move, just whether a landing counts
      as deferred.
    """

    slowdown: tuple = ()
    degradation: tuple = ()
    node_loss: tuple | None = None
    grants: tuple = ()
    adaptive_deadline: bool = False

    def __post_init__(self):
        object.__setattr__(self, "slowdown", tuple(tuple(int(x) for x in e) for e in self.slowdown))
        object.__setattr__(
            self, "degradation", tuple(tuple(int(x) for x in e) for e in self.degradation))
        object.__setattr__(self, "grants", tuple(tuple(int(x) for x in e) for e in self.grants))
        if self.node_loss is not None:
            object.__setattr__(self, "node_loss", tuple(int(x) for x in self.node_loss))
        for name, width in (("slowdown", 4), ("degradation", 4), ("grants", 4)):
            for e in getattr(self, name):
                if len(e) != width:
                    raise ValueError(f"{name} entries are {width}-tuples, got {e}")
        if self.node_loss is not None and len(self.node_loss) != 2:
            raise ValueError(f"node_loss is (shard, step), got {self.node_loss}")
        for _, factor, onset, recovery in self.slowdown:
            if factor < 1 or onset < 0 or recovery <= onset:
                raise ValueError("slowdown needs factor >= 1 and onset < recovery")
        for _, budget, onset, recovery in self.degradation:
            if budget < 0 or onset < 0 or recovery <= onset:
                raise ValueError("degradation needs budget >= 0 and onset < recovery")
        for _, grant, onset, recovery in self.grants:
            if grant < 0 or onset < 0 or recovery <= onset:
                raise ValueError("grants need grant >= 0 and onset < recovery")

    @property
    def any_faults(self) -> bool:
        return bool(self.slowdown or self.degradation or self.grants
                    or self.node_loss is not None)

    def to_json(self) -> str:
        return json.dumps({
            "slowdown": [list(e) for e in self.slowdown],
            "degradation": [list(e) for e in self.degradation],
            "node_loss": list(self.node_loss) if self.node_loss is not None else None,
            "grants": [list(e) for e in self.grants],
            "adaptive_deadline": self.adaptive_deadline,
        }, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "ChaosSpec":
        d = json.loads(text)
        return cls(
            slowdown=tuple(tuple(e) for e in d.get("slowdown", ())),
            degradation=tuple(tuple(e) for e in d.get("degradation", ())),
            node_loss=tuple(d["node_loss"]) if d.get("node_loss") else None,
            grants=tuple(tuple(e) for e in d.get("grants", ())),
            adaptive_deadline=bool(d.get("adaptive_deadline", False)),
        )


def compile_chaos(spec: ChaosSpec, *, n_steps: int, n_streams: int, n_shards: int,
                  n_pages: int, placement: str, base_budget: int | None) -> dict:
    """Lower a spec to dense numpy tables for ``n_steps`` steps.

    Returns a dict with:

    * ``dilation``  int32 ``[T, G]`` — physical-delay multiplier, default 1.
    * ``budget``    int32 ``[T, G]`` — per-NIC budget, ``INF`` when unlimited
      (``base_budget`` is the clean-run value; ``None`` means unlimited).
    * ``grant``     int32 ``[T, S]`` — per-stream footprint cap, default INF.
    * ``home``      int32 ``[2, n_pages]`` — row 0 the physical placement
      home, row 1 the post-death re-homed map (== row 0 when no node loss).
    * ``dead_pages`` int32 ``[n_dead]`` — pages homed on the lost shard.
    * ``t_fail``    int — death step, or ``None``.

    Every consumer reads *these arrays*, never the raw spec, so fault timing
    cannot diverge between them.
    """
    T, S, G = int(n_steps), int(n_streams), int(n_shards)
    dilation = np.ones((T, G), dtype=np.int32)
    for shard, factor, onset, recovery in spec.slowdown:
        if not (0 <= shard < G):
            raise ValueError(f"slowdown shard {shard} out of range for {G} shards")
        dilation[min(onset, T):min(recovery, T), shard] = factor

    base = INF if base_budget is None else int(base_budget)
    budget = np.full((T, G), base, dtype=np.int32)
    for shard, cap, onset, recovery in spec.degradation:
        if not (0 <= shard < G):
            raise ValueError(f"degradation shard {shard} out of range for {G} shards")
        budget[min(onset, T):min(recovery, T), shard] = min(cap, base)

    grant = np.full((T, S), INF, dtype=np.int32)
    for stream, cap, onset, recovery in spec.grants:
        if not (0 <= stream < S):
            raise ValueError(f"grant stream {stream} out of range for {S} streams")
        grant[min(onset, T):min(recovery, T), stream] = cap

    # Pure-numpy page_home (the tables are built once, on the host).
    pages = np.arange(n_pages, dtype=np.int64)
    if placement == "interleave":
        home0 = (pages % G).astype(np.int32)
    elif placement == "block":
        home0 = (pages // (n_pages // G)).astype(np.int32)
    else:
        raise ValueError(f"unknown placement {placement!r}")
    home1 = home0.copy()
    dead_pages = np.zeros((0,), dtype=np.int32)
    t_fail = None
    if spec.node_loss is not None:
        dead, t_fail = spec.node_loss
        if G < 2:
            raise ValueError("node_loss needs at least 2 shards")
        if not (0 <= dead < G):
            raise ValueError(f"node_loss shard {dead} out of range for {G} shards")
        dead_pages = np.nonzero(home0 == dead)[0].astype(np.int32)
        for p in dead_pages:
            home1[p] = rehome_shard(int(p), dead, dead, G)
        t_fail = int(t_fail)

    return {
        "dilation": dilation,
        "budget": budget,
        "grant": grant,
        "home": np.stack([home0, home1]),
        "dead_pages": dead_pages,
        "t_fail": t_fail,
    }
