"""Launch wrappers of the CUDA page-gather kernels (``csrc/gather_pages.cu``).

Replaces the Pallas TPU kernels ``gather_pages_fwd`` and
``gather_pages_async_fwd`` (``src/repro/kernels/gather_pages/kernel.py``).

Bound on the H100: memory, ``2 * K * E * itemsize`` bytes (each requested
row read once, each output row written once) over 3.35 TB/s. At the
serving path's widths (an 8 KB bf16 KV page, 48 to 96 pages a call) that is
under a microsecond, so a call is bound by launch latency and by this
wrapper's host work, which is kept lean: one boolean expression holds every
input check (the slow path names the failing one), the raw current stream
is read without building a ``torch.cuda.Stream``, and the device is
entered only when it is not the current one (``_build.launch``).

The sync kernel gives every (row, 8 KB tile) its own block of 16-byte
vector copies. The async kernel moves each tile with Hopper's bulk
asynchronous copies (global -> shared on an mbarrier, shared -> global),
one elected thread a block issuing all of its tiles' loads before its first
wait — the Hopper form of the TPU kernel's issue/wait DMA ring — with the
grid sized so that every tile of the call is in flight at once. Both copy
raw bytes (16-byte pieces when rows and bases are 16-byte aligned, single
bytes otherwise), so one kernel serves every dtype, and their outputs are
equal byte for byte.
"""

from __future__ import annotations

import torch

from .. import _build

gather_pages_launches = _build.counter("gather_pages")
gather_pages_async_launches = _build.counter("gather_pages_async")

_ARGS = [_build.VP, _build.VP, _build.VP, _build.I32, _build.I32,
         _build.I64, _build.VP]


def _check(pool: torch.Tensor, idx: torch.Tensor) -> None:
    """Raise naming the first input check that fails."""
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
    # every test of _check, in few attribute reads for the common call
    if not (pool.is_cuda and idx.is_cuda and pool.dim() == 2
            and idx.dim() == 1 and idx.dtype is torch.int32
            and pool.is_contiguous() and idx.is_contiguous()):
        _check(pool, idx)
    dev = pool.get_device()
    n_pages, E = pool.shape
    if n_pages < 1 or idx.get_device() != dev:
        _check(pool, idx)
    K = idx.shape[0]
    out = pool.new_empty(K, E)
    fn = _build.bind("gather_pages", entry, _ARGS)
    code = _build.launch(fn, dev, pool.data_ptr(), idx.data_ptr(),
                         out.data_ptr(), n_pages, K,
                         E * pool.element_size())
    if code:
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
    (bulk asynchronous copies, every tile's load issued before the first
    wait)."""
    return _launch("gather_pages_async_launch", gather_pages_async_launches,
                   pool, indices)
