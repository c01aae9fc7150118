"""Launch wrappers of the CUDA paged-attention kernels
(``csrc/paged_attention.cu``).

Replaces the Pallas TPU kernels ``paged_attention_fwd``,
``paged_attention_hot_slots_fwd`` and ``paged_attention_hot_slots_async_fwd``
(``src/repro/kernels/paged_attention/kernel.py``). The Pallas kernels walk
the pages as the innermost, sequential grid dimension of one core; here the
pages of each (sequence, KV head) are split across blocks (flash-decoding):
block ``(b, h, s)`` runs the f32 online softmax over pages
``[s * P, min((s + 1) * P, npps))`` in table order and writes its partial
``(m, l, acc)`` to an f32 workspace this wrapper allocates, and a second
kernel of the same C call merges the ``n_split`` partials in split order.
The per-page update runs on the tensor cores (``mma.sync``, bf16 operands,
f32 accumulation, P in three bf16 parts) for bf16 at page size 16 and head
dim 64 or 128, and on the CUDA cores (16-byte lane shares of each K/V row,
fixed-order shuffle trees) otherwise. :func:`split_pages` and
:func:`tensor_core_route` see only the call's shape and dtype, and the
three kernels run the same update, merge and combine, so their outputs are
bitwise equal on the same bytes. The async kernel copies the next valid
page of its split with ``cp.async`` before it waits on the current one.

Bound on the H100: memory -- the K/V bytes of the valid tokens plus q and
o over 3.35 TB/s (about 5 us at the synthetic serve's 8 x 2,064-token bf16
batch, 1.3 us at the model serve's 4 x 1,040). The split gives such a batch
about two blocks a SM; what is left above the bound is the latency of a
block's few pages and merge and the combine's second launch (PERF.md).
"""

from __future__ import annotations

import torch

from .. import _build

#: the page size and head dims of the bf16 tensor-core route
MMA_PAGE = 16
MMA_HEAD_DIMS = (64, 128)
#: blocks the split rule aims for: two on each of the H100's 132 SMs
TARGET_BLOCKS = 264
#: the fewest pages a split takes when the pages are split at all
MIN_PAGES_PER_SPLIT = 2


def split_pages(B: int, Hkv: int, npps: int) -> tuple[int, int]:
    """``(pages_per_split, n_split)`` of a call with ``B`` query rows of
    ``Hkv`` KV heads over tables of ``npps`` pages.

    The rule sees the shape alone, never the lengths or the table, so two
    calls with the same ``q`` batch and the same ``npps`` (the flat and the
    hot-slot kernel under the engine's pin) split alike. It aims for
    ``B * Hkv * n_split >= TARGET_BLOCKS``: ``n_split`` splits of
    ``P = max(ceil(npps / ceil(TARGET_BLOCKS / (B * Hkv))), 2)`` pages,
    ``n_split = ceil(npps / P)``. So every page lies in exactly one split,
    the last split may be short, and ``n_split = 1`` (``P = npps``) when
    ``B * Hkv`` alone reaches the target or the table has at most 2 pages.
    """
    rows = B * Hkv
    if rows <= 0 or npps <= MIN_PAGES_PER_SPLIT:
        return max(npps, 1), 1
    want = -(-TARGET_BLOCKS // rows)             # splits a row
    pps = min(max(-(-npps // want), MIN_PAGES_PER_SPLIT), npps)
    return pps, -(-npps // pps)


def tensor_core_route(dtype: torch.dtype, page_size: int, dh: int) -> bool:
    """Whether a call runs its scores and P.V on the tensor cores
    (``mma.sync``, bf16 operands, f32 accumulation, P in three bf16 parts)
    or on the CUDA cores: bf16 at page size 16 and head dim 64 or 128, the
    serving paths' shapes, take the tensor cores; f32 (TF32 would miss
    2e-5) and every other shape the CUDA cores. Like the split, a function
    of the call's shape and dtype alone, so a pinned pair takes one route.
    """
    return (dtype == torch.bfloat16 and page_size == MMA_PAGE
            and dh in MMA_HEAD_DIMS)


paged_attention_launches = _build.counter("paged_attention")
paged_attention_hot_slots_launches = _build.counter("paged_attention_hot_slots")
paged_attention_hot_slots_async_launches = _build.counter(
    "paged_attention_hot_slots_async")
#: launches of any of the three on the tensor-core route
paged_attention_mma_launches = _build.counter("paged_attention_mma")
#: by kernel name, the split and route its latest launch passed to the C
#: entry point: ``{"pages_per_split", "n_split", "tensor_cores"}``
last_launch: dict[str, dict] = {}

_ARGS = [_build.VP] * 7 + [_build.I32] * 10 + [_build.F32, _build.I32,
                                                _build.VP]
#: the largest K/V row the kernels take: 32 lanes of four 16-byte chunks
#: (head dim 1024 in bf16, 512 in f32)
MAX_ROW_BYTES = 2048
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
    if q.shape[3] * q.element_size() > MAX_ROW_BYTES:
        raise ValueError(f"{name} kernel: rows of {q.shape[3]} x "
                         f"{q.element_size()} bytes exceed {MAX_ROW_BYTES}")


def _launch(entry, counter, name, q, k, v, table, lengths, n_valid,
            page_size, sm_scale):
    B, Hkv, G, dh = q.shape
    npps = table.shape[1]
    pps, n_split = split_pages(B, Hkv, npps)
    mma = tensor_core_route(q.dtype, page_size, dh)
    out = torch.empty_like(q)
    # the splits' partials: acc [B*Hkv, n_split, G, dh], then m and l
    ws = (q.new_empty(B * Hkv * n_split * G * (dh + 2), dtype=torch.float32)
          if n_split > 1 else None)
    fn = _build.bind("paged_attention", entry, _ARGS)
    code = _build.launch(fn, q.get_device(), q.data_ptr(), k.data_ptr(),
                         v.data_ptr(), table.data_ptr(), lengths.data_ptr(),
                         out.data_ptr(), None if ws is None else ws.data_ptr(),
                         B, Hkv, G, dh, page_size, npps, n_valid, pps,
                         n_split, int(mma), float(sm_scale or 1.0 / dh ** 0.5),
                         _DTYPES[q.dtype])
    _build.check(code, name)
    counter.n += 1
    if mma:
        paged_attention_mma_launches.n += 1
    last_launch[name] = {"pages_per_split": pps, "n_split": n_split,
                         "tensor_cores": mma}
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
    """:func:`paged_attention_hot_slots_fwd` with each split's next valid
    page copied by ``cp.async`` while the current one is attended; bitwise
    equal to it."""
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
