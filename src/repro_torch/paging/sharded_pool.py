"""The one-shard subset of the sharded cold pool (``paging/sharded_pool.py``).

On a single H100 the tiered sweep runs the degenerate one-shard fabric: the
whole link budget on one NIC, every page near. A fabric of more than one
shard is ported in a later slice; asking for it raises.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.pool import PLACEMENTS


@dataclasses.dataclass(frozen=True)
class ShardedPoolCfg:
    """Static fabric topology of the cold pool (see the reference)."""
    n_shards: int = 1
    placement: str = "interleave"
    link_budget: int | None = None
    near_delay: int = 1
    far_delay: int = 2

    def __post_init__(self):
        if self.placement not in PLACEMENTS:
            raise ValueError(f"placement must be one of {PLACEMENTS}, "
                             f"got {self.placement!r}")
        if self.n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if not 1 <= self.near_delay <= self.far_delay:
            raise ValueError("need 1 <= near_delay <= far_delay "
                             f"(got {self.near_delay}/{self.far_delay})")


def stream_homes(n_streams: int, n_shards: int, device=None) -> torch.Tensor:
    """Home shard of each stream: ``s % n_shards``."""
    return torch.remainder(torch.arange(n_streams, dtype=torch.int32,
                                        device=device), n_shards)


def check_fabric_topology(n_pages: int, fabric: ShardedPoolCfg,
                          mesh=None) -> None:
    """Entry-point validation; more than one shard is not ported yet."""
    if fabric.n_shards > 1 or mesh is not None:
        raise NotImplementedError(
            "a sharded cold pool (n_shards > 1 or a mesh) is ported in a "
            "later slice; see ROADMAP")
    if n_pages % fabric.n_shards:
        raise ValueError(f"n_pages={n_pages} not divisible by "
                         f"n_shards={fabric.n_shards}")


def scatter_hot(hot: dict, data: dict, dst: torch.Tensor,
                mask: torch.Tensor) -> dict:
    """Write gathered pages (leaves ``[S, K, ...page]``) into the stacked
    ``[S, n_slots, ...]`` hot pools at per-stream slots ``dst [S, K]`` where
    ``mask``, IN PLACE; returns ``hot``.

    Masked-out entries write nothing, even where they name a live entry's
    slot. The live slots of one stream must be distinct: a scatter with
    duplicate indices has no defined order on CUDA. The tiered sweep's copy
    plans never name one slot twice in a chunk step (a test pins this).
    """
    s_idx, k_idx = mask.nonzero(as_tuple=True)
    d_idx = dst[s_idx, k_idx].long()
    for name, h in hot.items():
        h[s_idx, d_idx] = data[name][s_idx, k_idx].to(h.dtype)
    return hot
