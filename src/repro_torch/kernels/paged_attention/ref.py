"""Plain PyTorch versions of paged decode attention: gather, exact softmax.

Both mask invalid table entries (negative, or past the pool / slot edge)
out of the softmax; the gather index is clamped only to stay in range. The
hot-slot version gathers into the same ``[S, T, Hkv, dh]`` layout as the
flat one and runs the same masked softmax, so on the same bytes the two are
bitwise equal, on the CPU too.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _masked_softmax_attend(q, k, v, mask, sm_scale):
    """q [B,Hkv,G,dh]; k/v [B,T,Hkv,dh] f32; mask [B,T] -> [B,Hkv,G,dh]."""
    s = torch.einsum("bhgd,bthd->bhgt", q.float(), k) * sm_scale
    s = torch.where(mask[:, None, None, :], s,
                    torch.full((), NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgt,bthd->bhgd", p, v).to(q.dtype)


def _token_mask(valid: torch.Tensor, lengths: torch.Tensor,
                page_size: int) -> torch.Tensor:
    B, npps = valid.shape
    T = npps * page_size
    pos = torch.arange(T, device=valid.device)[None, :]
    return (pos < lengths[:, None]) & valid.repeat_interleave(page_size, dim=1)


def paged_attention_ref(q, k_pool, v_pool, page_table, lengths,
                        sm_scale: float | None = None) -> torch.Tensor:
    """q [B,Hkv,G,dh]; pools [n_pages,page,Hkv,dh]; page_table [B,npps];
    lengths [B] -> [B,Hkv,G,dh] in q's dtype."""
    B, Hkv, G, dh = q.shape
    n_pages, page_size = k_pool.shape[0], k_pool.shape[1]
    valid = (page_table >= 0) & (page_table < n_pages)
    pt = page_table.clamp(0, n_pages - 1).long()
    T = pt.shape[1] * page_size
    k = k_pool[pt].reshape(B, T, Hkv, dh).float()
    v = v_pool[pt].reshape(B, T, Hkv, dh).float()
    mask = _token_mask(valid, lengths, page_size)
    return _masked_softmax_attend(q, k, v, mask, sm_scale or 1.0 / dh ** 0.5)


def paged_attention_hot_slots_ref(q, k_hot, v_hot, slot_table, lengths,
                                  sm_scale: float | None = None
                                  ) -> torch.Tensor:
    """q [S,Hkv,G,dh]; hot pools [S,n_slots,page,Hkv,dh]; slot_table [S,npps]
    per-stream slot ids (-1 or out of range = masked); lengths [S]."""
    S, Hkv, G, dh = q.shape
    n_slots, page_size = k_hot.shape[1], k_hot.shape[2]
    valid = (slot_table >= 0) & (slot_table < n_slots)
    st = slot_table.clamp(0, n_slots - 1).long()
    rows = torch.arange(S, device=st.device)[:, None]
    T = st.shape[1] * page_size
    k = k_hot[rows, st].reshape(S, T, Hkv, dh).float()
    v = v_hot[rows, st].reshape(S, T, Hkv, dh).float()
    mask = _token_mask(valid, lengths, page_size)
    return _masked_softmax_attend(q, k, v, mask, sm_scale or 1.0 / dh ** 0.5)
