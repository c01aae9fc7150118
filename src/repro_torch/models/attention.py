"""GQA attention of the model: one-token decode and full-sequence prefill
(self- or cross-attention).

Counterpart of ``repro.models.attention``. All share its contract:
``q [B,Sq,Hq,dh]``, ``k/v [B,Sk,Hkv,dh]`` with ``Hq = G*Hkv``; softmax
statistics in float32; outputs in the input dtype. Its TPU layout flags
(``attn_bf16``, ``decode_tsh``) stay off, as in its default. Logit
soft-capping is not ported (no config sets it, and the flash kernel has
no soft-cap; ROADMAP queue 1 item 6).

* :func:`decode_attention` — one query position against a ``[B,T,...]``
  cache, masked to ``length``; plain PyTorch, as the reference's is jnp.
* :func:`blocked_attention` — the whole prompt at once for ``prefill``
  (causal, or a sliding window, or unmasked in an encoder and in the
  encoder-decoder's prefill cross-attention, whose ``Sq`` and ``Sk`` may
  differ): the reference's ``blocked_attention``, whose docstring names
  the Pallas flash kernel as its twin. Here it is that kernel's port
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


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, causal: bool = True,
                      window: int = 0) -> torch.Tensor:
    """GQA attention over the full sequence -> ``[B,Sq,Hq,dh]``: causal
    (``window`` > 0: each query sees its last ``window`` keys) or, with
    ``causal=False``, bidirectional."""
    return flash_attention(q, k, v, causal=causal, window=window)


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
