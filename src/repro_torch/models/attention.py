"""GQA attention of the model: one-token decode and causal full-sequence.

Counterpart of ``repro.models.attention``. Both share its contract:
``q [B,Sq,Hq,dh]``, ``k/v [B,Sk,Hkv,dh]`` with ``Hq = G*Hkv``; softmax
statistics in float32; outputs in the input dtype. Its TPU layout flags
(``attn_bf16``, ``decode_tsh``) stay off, as in its default; sliding
windows and logit soft-capping wait for the configs that use them (ROADMAP
queue 1 item 3).

* :func:`decode_attention` — one query position against a ``[B,T,...]``
  cache, masked to ``length``; plain PyTorch, as the reference's is jnp.
* :func:`causal_attention` — the whole prompt at once for ``prefill``: the
  reference's ``blocked_attention``, whose docstring names the Pallas
  flash kernel as its twin. Here it is that kernel's port
  (:func:`repro_torch.kernels.flash_attention.flash_attention`): the CUDA
  kernel for CUDA tensors, the exact-softmax plain version on the CPU.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import flash_attention

NEG_INF = -1e30


def _split_gqa(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[B,S,Hq,dh] -> [B,S,Hkv,G,dh]."""
    B, S, Hq, dh = q.shape
    return q.reshape(B, S, n_kv, Hq // n_kv, dh)


def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Causal GQA attention over the full sequence -> ``[B,Sq,Hq,dh]``."""
    return flash_attention(q, k, v, causal=True)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: int | torch.Tensor) -> torch.Tensor:
    """Single-position attention: q [B,1,Hq,dh] vs cache k/v [B,T,Hkv,dh].

    ``length`` (int or ``[B]`` tensor) masks the valid cache prefix.
    """
    B, _, Hq, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qg = _split_gqa(q, Hkv)[:, 0].float()                 # [B,Hkv,G,dh]
    s = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) / math.sqrt(dh)
    tpos = torch.arange(T, device=q.device)[None, :]
    # a host int compares as a scalar: no host-to-device copy per step
    ln = length[:, None] if torch.is_tensor(length) else length
    msk = tpos < ln                                       # [B or 1, T]
    s = torch.where(msk[:, None, None, :], s,
                    torch.full((), NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    return out.reshape(B, 1, Hq, dh).to(q.dtype)
