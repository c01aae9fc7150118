"""Launch wrappers of the CUDA page-gather kernels (``csrc/gather_pages.cu``).

Replaces the Pallas TPU kernels ``gather_pages_fwd`` and
``gather_pages_async_fwd`` (``src/repro/kernels/gather_pages/kernel.py``).

Bound on the H100: memory, ``2 * K * E * itemsize`` bytes (each requested
row read once, each output row written once) over 3.35 TB/s. At the
serving path's widths (an 8 KB bf16 KV page, about a hundred pages a call)
that is well under a microsecond, so a call is bound by launch latency.
The sync kernel gives every (row, 8 KB tile) its own block of 16-byte
vector copies; the async kernel walks four items per block through a
2-stage ``cp.async`` shared-memory ring, issuing item i+1 before it waits on
item i — the Hopper form of the TPU kernel's depth-2 DMA ring. Both copy
raw bytes (16-byte vectors when rows and bases are 16-byte aligned, single
bytes otherwise), so one kernel serves every dtype, and their outputs are
equal byte for byte.
"""

from __future__ import annotations

import torch

from .. import _build

gather_pages_launches = _build.counter("gather_pages")
gather_pages_async_launches = _build.counter("gather_pages_async")

_ARGS = [_build.VP, _build.VP, _build.VP, _build.I32, _build.I32,
         _build.I64, _build.I32, _build.VP]


def _check(pool: torch.Tensor, idx: torch.Tensor) -> None:
    if not (pool.is_cuda and idx.is_cuda):
        raise ValueError("gather_pages kernel: pool and indices must be CUDA "
                         "tensors")
    if pool.device != idx.device:
        raise ValueError("gather_pages kernel: pool and indices on different "
                         "devices")
    if pool.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"gather_pages kernel: want pool [n_pages, E] and "
                         f"indices [K], got {tuple(pool.shape)} / "
                         f"{tuple(idx.shape)}")
    if idx.dtype != torch.int32:
        raise ValueError(f"gather_pages kernel: indices must be int32, got "
                         f"{idx.dtype}")
    if not (pool.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_pages kernel: inputs must be contiguous")
    if pool.shape[0] < 1:
        raise ValueError("gather_pages kernel: empty pool")


def _launch(entry: str, counter, pool: torch.Tensor,
            idx: torch.Tensor) -> torch.Tensor:
    _check(pool, idx)
    n_pages, E = pool.shape
    K = idx.shape[0]
    out = torch.empty((K, E), dtype=pool.dtype, device=pool.device)
    row_bytes = E * pool.element_size()
    vec = int(row_bytes % 16 == 0 and pool.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0)
    fn = _build.bind("gather_pages", entry, _ARGS)
    with torch.cuda.device(pool.device):
        code = fn(pool.data_ptr(), idx.data_ptr(), out.data_ptr(), n_pages,
                  K, row_bytes, vec, _build.stream_ptr())
    _build.check(code, entry)
    counter.n += 1
    return out


def gather_pages_fwd(pool: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``pool [n_pages, E]``, ``indices int32[K]`` -> ``[K, E]``; indices
    clamped into range in the kernel."""
    return _launch("gather_pages_launch", gather_pages_launches, pool,
                   indices)


def gather_pages_async_fwd(pool: torch.Tensor,
                           indices: torch.Tensor) -> torch.Tensor:
    """Same contract and bytes as :func:`gather_pages_fwd`, issue/wait form
    (a 2-stage ``cp.async`` shared-memory ring per block)."""
    return _launch("gather_pages_async_launch", gather_pages_async_launches,
                   pool, indices)
