"""Paged decode attention in the model layout ``q [B, 1, Hq, dh]``.

Internally the query is regrouped to ``[B, Hkv, G, dh]``. A CUDA query goes
through the hand-written kernel (or raises); a CPU query, or
``use_kernel=False``, takes the plain version.
"""

from __future__ import annotations

import torch

from .kernel import (paged_attention_fwd,
                     paged_attention_hot_slots_async_fwd,
                     paged_attention_hot_slots_fwd)
from .ref import paged_attention_hot_slots_ref, paged_attention_ref


def paged_attention(q, k_pool, v_pool, page_table, lengths, *,
                    use_kernel: bool = True) -> torch.Tensor:
    """q [B,1,Hq,dh] vs the flat pool [n_pages,page,Hkv,dh] -> [B,1,Hq,dh].

    Invalid table entries (< 0 or >= n_pages) are masked out of the
    softmax, never read as page 0's bytes.
    """
    B, _, Hq, dh = q.shape
    Hkv = k_pool.shape[2]
    qg = q[:, 0].reshape(B, Hkv, Hq // Hkv, dh)
    pt = page_table.to(torch.int32)
    ln = lengths.to(torch.int32)
    if use_kernel and q.is_cuda:
        o = paged_attention_fwd(qg.contiguous(), k_pool, v_pool,
                                pt.contiguous(), ln.contiguous(),
                                sm_scale=1.0 / dh ** 0.5)
    else:
        o = paged_attention_ref(qg, k_pool, v_pool, pt, ln,
                                sm_scale=1.0 / dh ** 0.5)
    return o.reshape(B, 1, Hq, dh)


def paged_attention_hot_slots(q, k_hot, v_hot, slot_table, lengths, *,
                              use_kernel: bool = True,
                              async_copy: bool = False) -> torch.Tensor:
    """Fused hot-slot attention: q [S,1,Hq,dh] vs the per-stream hot pools
    [S,n_slots,page,Hkv,dh] read in place through ``slot_table [S,npps]``.

    Entries < 0 or >= n_slots are masked. ``async_copy=True`` launches the
    double-buffered kernel, bitwise equal to the sync one; both have the
    same plain version.
    """
    S, _, Hq, dh = q.shape
    Hkv = k_hot.shape[3]
    qg = q[:, 0].reshape(S, Hkv, Hq // Hkv, dh)
    st = slot_table.to(torch.int32)
    ln = lengths.to(torch.int32)
    if use_kernel and q.is_cuda:
        fwd = (paged_attention_hot_slots_async_fwd if async_copy
               else paged_attention_hot_slots_fwd)
        o = fwd(qg.contiguous(), k_hot, v_hot, st.contiguous(),
                ln.contiguous(), sm_scale=1.0 / dh ** 0.5)
    else:
        o = paged_attention_hot_slots_ref(qg, k_hot, v_hot, st, ln,
                                          sm_scale=1.0 / dh ** 0.5)
    return o.reshape(S, 1, Hq, dh)
