"""Launch wrappers of the CUDA paged-attention kernels
(``csrc/paged_attention.cu``).

Replaces the Pallas TPU kernels ``paged_attention_fwd``,
``paged_attention_hot_slots_fwd`` and ``paged_attention_hot_slots_async_fwd``
(``src/repro/kernels/paged_attention/kernel.py``). One block per (sequence,
KV head) loops the pages in table order with an f32 online softmax; the G
grouped query heads share each K/V page tile in shared memory. The three
kernels differ only in how a table entry becomes a page address and, for
the async one, in how the tile reaches shared memory (a 2-stage
``cp.async`` ring that issues the next valid page before it waits on the
current one); all run the same per-page update, so their outputs are
bitwise equal on the same bytes.

Bound on the H100: memory — the K/V bytes of the valid tokens plus q and
o over 3.35 TB/s (about 5 µs at the serving path's 8 x 2048-token bf16
batch). With one block per (sequence, KV head) that batch fills 16 of 132
SMs, so the kernel sits far from the bound; a page split across blocks is
later work and must split both kernels the same way.
"""

from __future__ import annotations

import torch

from .. import _build

paged_attention_launches = _build.counter("paged_attention")
paged_attention_hot_slots_launches = _build.counter("paged_attention_hot_slots")
paged_attention_hot_slots_async_launches = _build.counter(
    "paged_attention_hot_slots_async")

_ARGS = [_build.VP] * 6 + [_build.I32] * 7 + [_build.F32, _build.I32,
                                               _build.VP]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v, table, lengths, pool_rank: int, name: str) -> None:
    ts = (q, k, v, table, lengths)
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"{name} kernel: every input must be a CUDA tensor")
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"{name} kernel: inputs on different devices")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name} kernel: q/k/v must share dtype float32 or "
                         f"bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError(f"{name} kernel: table and lengths must be int32")
    if q.dim() != 4 or k.dim() != pool_rank or k.shape != v.shape:
        raise ValueError(f"{name} kernel: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if table.dim() != 2 or table.shape[0] != q.shape[0] \
            or lengths.shape != (q.shape[0],):
        raise ValueError(f"{name} kernel: table [B, npps] and lengths [B] "
                         f"must match q's batch")
    if k.shape[-2] != q.shape[1] or k.shape[-1] != q.shape[3]:
        raise ValueError(f"{name} kernel: KV heads / head dim of the pool "
                         f"{tuple(k.shape[-2:])} do not match q")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} kernel: inputs must be contiguous")


def _launch(entry, counter, name, q, k, v, table, lengths, n_valid,
            page_size, sm_scale):
    B, Hkv, G, dh = q.shape
    out = torch.empty_like(q)
    fn = _build.bind("paged_attention", entry, _ARGS)
    code = _build.launch(fn, q.get_device(), q.data_ptr(), k.data_ptr(),
                         v.data_ptr(), table.data_ptr(), lengths.data_ptr(),
                         out.data_ptr(), B, Hkv, G, dh, page_size,
                         table.shape[1], n_valid,
                         float(sm_scale or 1.0 / dh ** 0.5), _DTYPES[q.dtype])
    _build.check(code, name)
    counter.n += 1
    return out


def paged_attention_fwd(q, k_pool, v_pool, page_table, lengths, *,
                        sm_scale: float | None = None) -> torch.Tensor:
    """q [B,Hkv,G,dh]; pools [n_pages,page,Hkv,dh]; page_table int32
    [B,npps]; lengths int32 [B] -> [B,Hkv,G,dh]. Entries < 0 or >= n_pages
    are masked."""
    _check(q, k_pool, v_pool, page_table, lengths, 4, "paged_attention")
    return _launch("paged_attention_launch", paged_attention_launches,
                   "paged_attention", q, k_pool, v_pool, page_table, lengths,
                   k_pool.shape[0], k_pool.shape[1], sm_scale)


def paged_attention_hot_slots_fwd(q, k_hot, v_hot, slot_table, lengths, *,
                                  sm_scale: float | None = None
                                  ) -> torch.Tensor:
    """q [S,Hkv,G,dh]; hot pools [S,n_slots,page,Hkv,dh] read in place;
    slot_table int32 [S,npps] per-stream slot ids; lengths int32 [S].
    Entries < 0 or >= n_slots are masked."""
    return _hot_slots("paged_attention_hot_slots_launch",
                      paged_attention_hot_slots_launches,
                      "paged_attention_hot_slots", q, k_hot, v_hot,
                      slot_table, lengths, sm_scale)


def paged_attention_hot_slots_async_fwd(q, k_hot, v_hot, slot_table,
                                        lengths, *,
                                        sm_scale: float | None = None
                                        ) -> torch.Tensor:
    """:func:`paged_attention_hot_slots_fwd` with the K/V page tiles
    double-buffered by ``cp.async``; bitwise equal to it."""
    return _hot_slots("paged_attention_hot_slots_async_launch",
                      paged_attention_hot_slots_async_launches,
                      "paged_attention_hot_slots_async", q, k_hot, v_hot,
                      slot_table, lengths, sm_scale)


def _hot_slots(entry, counter, name, q, k_hot, v_hot, slot_table, lengths,
               sm_scale):
    _check(q, k_hot, v_hot, slot_table, lengths, 5, name)
    if k_hot.shape[0] != q.shape[0]:
        raise ValueError(f"{name} kernel: hot pools must have one stream "
                         "per q row")
    return _launch(entry, counter, name, q, k_hot, v_hot, slot_table,
                   lengths, k_hot.shape[1], k_hot.shape[2], sm_scale)
