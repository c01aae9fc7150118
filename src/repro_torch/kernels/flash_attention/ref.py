"""Plain PyTorch version of GQA prefill attention: exact softmax.

Counterpart of ``src/repro/kernels/flash_attention/ref.py``: the same
``[B, H, S, dh]`` contract as the kernel, scores in float32 over K/V
repeated to the query heads, causal / sliding-window masks placed by
``q_offset``, fully masked rows 0 (not NaN).
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        q_offset: int = 0) -> torch.Tensor:
    """q [B,Hq,Sq,dh], k/v [B,Hkv,Sk,dh] -> [B,Hq,Sq,dh] in q's dtype."""
    B, Hq, Sq, dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kx = k.repeat_interleave(G, dim=1).float()
    vx = v.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhqd,bhsd->bhqs", q.float(), kx) / math.sqrt(dh)
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, torch.full((), NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask, p, torch.zeros((), device=p.device))
    return torch.einsum("bhqs,bhsd->bhqd", p, vx).to(q.dtype)
