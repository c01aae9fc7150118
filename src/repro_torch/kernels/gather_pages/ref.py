"""Plain PyTorch version of the page gather (the CPU path and the oracle)."""

from __future__ import annotations

import torch


def gather_pages_ref(pool: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``pool [n_pages, E]``, ``indices [K]`` -> ``pool[clamp(indices)]``."""
    idx = indices.clamp(0, pool.shape[0] - 1).long()
    return pool[idx]
