"""Page gather over any page shape: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors (or when the caller opts out)."""

from __future__ import annotations

import torch

from .kernel import gather_pages_async_fwd, gather_pages_fwd
from .ref import gather_pages_ref


def _gather(fwd, pool: torch.Tensor, indices: torch.Tensor,
            use_kernel: bool) -> torch.Tensor:
    flat = pool.reshape(pool.shape[0], -1)
    idx = indices.to(torch.int32)
    if use_kernel and pool.is_cuda:
        out = fwd(flat.contiguous(), idx.contiguous())
    else:
        out = gather_pages_ref(flat, idx)
    return out.reshape((indices.shape[0],) + tuple(pool.shape[1:]))


def gather_pages(pool: torch.Tensor, indices: torch.Tensor, *,
                 use_kernel: bool = True) -> torch.Tensor:
    """``pool [n_pages, ...page]``, ``indices [K]`` -> ``[K, ...page]``.

    Out-of-range indices are clamped. A CUDA pool goes through the kernel
    (or raises); a CPU pool, or ``use_kernel=False``, takes the plain
    version, which gathers identical bytes.
    """
    return _gather(gather_pages_fwd, pool, indices, use_kernel)


def gather_pages_async(pool: torch.Tensor, indices: torch.Tensor, *,
                       use_kernel: bool = True) -> torch.Tensor:
    """Issue/wait gather: the same contract and bytes as
    :func:`gather_pages`, through the ``cp.async`` ring kernel."""
    return _gather(gather_pages_async_fwd, pool, indices, use_kernel)
