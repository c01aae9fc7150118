"""Plain PyTorch version of GQA prefill attention: exact softmax.

Counterpart of ``src/repro/kernels/flash_attention/ref.py``: the same
``[B, H, S, dh]`` contract as the kernel, scores in float32 over K/V
repeated to the query heads, soft-capped (``softcap`` > 0: ``tanh(s /
softcap) * softcap``, before the mask, as the reference's
``full_attention``), causal / sliding-window masks placed by
``q_offset``, fully masked rows 0 (not NaN). And the plain versions of
the passes that feed the kernel, the split route's
:func:`split_bf16x3_ref` and the pack :func:`pack_bf16_ref`, which only
the tests and the chip smoke call.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        q_offset: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """q [B,Hq,Sq,dh], k/v [B,Hkv,Sk,dh] -> [B,Hq,Sq,dh] in q's dtype."""
    B, Hq, Sq, dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kx = k.repeat_interleave(G, dim=1).float()
    vx = v.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhqd,bhsd->bhqs", q.float(), kx) / math.sqrt(dh)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
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


def split_bf16x3_ref(x: torch.Tensor) -> torch.Tensor:
    """x float32 -> ``[3, *x.shape]`` bfloat16: hi = bf16(x), mid =
    bf16(x - hi), lo = bf16(x - hi - mid), each rounded to nearest even.
    Both differences are exact in float32, and hi + mid + lo is x to its
    last bit for normal x."""
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return torch.stack([hi, mid, lo])


def pack_bf16_ref(x: torch.Tensor) -> torch.Tensor:
    """x ``[..., dh]`` -> a contiguous ``[..., dhp]`` copy, ``dhp`` = ``dh``
    rounded up to 8, the columns past ``dh`` zero."""
    return torch.nn.functional.pad(x, (0, -x.shape[-1] % 8)).contiguous()
