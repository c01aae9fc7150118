"""GQA attention of the model: one-token decode, full-sequence prefill
(self- or cross-attention) and the differentiable training route.

Counterpart of ``repro.models.attention``. All share its contract:
``q [B,Sq,Hq,dh]``, ``k/v [B,Sk,Hkv,dh]`` with ``Hq = G*Hkv``; softmax
statistics in float32; outputs in the input dtype. Its TPU layout flags
(``attn_bf16``, ``decode_tsh``) stay off, as in its default. Each takes
the reference's ``softcap``: with a cap > 0 the scaled scores become
``tanh(s / softcap) * softcap`` before the mask (the model's
``attn_logit_softcap``); in :func:`blocked_attention` the flash kernel
applies it in its score tile.

* :func:`decode_attention` — one query position against a ``[B,T,...]``
  cache, masked to ``length``; plain PyTorch, as the reference's is jnp.
* :func:`blocked_attention` — the whole prompt at once for ``prefill``
  (causal, or a sliding window, or unmasked in an encoder and in the
  encoder-decoder's prefill cross-attention, whose ``Sq`` and ``Sk`` may
  differ): the reference's ``blocked_attention``, whose docstring names
  the Pallas flash kernel as its twin. Here it is that kernel's port
  (:func:`repro_torch.kernels.flash_attention.flash_attention`): the CUDA
  kernel for CUDA tensors, the exact-softmax plain version on the CPU.
  The kernel is forward-only, and its wrapper refuses inputs that
  require grad under grad mode.
* :func:`train_attention` — the route of ``Transformer.train_forward``:
  the reference's ``blocked_attention`` as it is differentiated there, a
  loop over query chunks, each under ``torch.utils.checkpoint``, around
  :func:`_attention_q_chunk`, an online-softmax sweep over every key block
  (masked where inactive) in float32 with ``q`` pre-scaled. Plain
  PyTorch on both devices, as the reference's is jnp: autograd
  differentiates it, and backward recomputes one query chunk's sweep at a
  time. On DTensors (the sharded train step) it runs on each rank's
  shards, as GSPMD runs the reference's head-sharded attention: q / k /
  v keep their batch and head shards (the heads' only where they split
  the KV heads evenly), gather the sequence and head width, and each
  rank attends its own rows and heads; the result is a DTensor of q's
  placements.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.activations import (decode_logits_constraint,
                                                 is_dtensor, on_shards,
                                                 split_evenly)
from repro_torch.kernels.flash_attention import flash_attention

NEG_INF = -1e30


def _split_gqa(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[B,S,Hq,dh] -> [B,S,Hkv,G,dh] (a DTensor's heads gathered first
    where their shards would not fall on whole KV heads)."""
    B, S, Hq, dh = q.shape
    q = split_evenly(q, 2, n_kv)
    return q.reshape(B, S, n_kv, Hq // n_kv, dh)


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, causal: bool = True, window: int = 0,
                      softcap: float = 0.0) -> torch.Tensor:
    """GQA attention over the full sequence -> ``[B,Sq,Hq,dh]``: causal
    (``window`` > 0: each query sees its last ``window`` keys) or, with
    ``causal=False``, bidirectional; ``softcap`` > 0 soft-caps the
    scores. CUDA DTensors go to the kernel, which takes plain tensors, on
    each rank's batch rows and heads (``on_shards``, as GSPMD runs
    attention); on any other device a DTensor runs the plain version as
    DTensor ops, whose products the dry run counts whole."""
    if is_dtensor(q) and q.is_cuda:
        (q_, k_, v_), wrap = on_shards((q, k, v), (0, 2),
                                       divides=_split_heads(k))
        return wrap(flash_attention(q_, k_, v_, causal=causal,
                                    window=window, softcap=softcap),
                    q.shape)
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap)


def _attention_q_chunk(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       q0: int, *, causal: bool, window: int,
                       softcap: float, block_k: int) -> torch.Tensor:
    """Online-softmax sweep of all key blocks for one query chunk.

    ``qg [B,Hkv,G,Cq,dh]`` float32, pre-scaled; ``k``/``v [B,Sk,Hkv,dh]``;
    ``q0`` the chunk's first query row. Returns ``[B,Hkv,G,Cq,dh]``
    float32."""
    B, Hkv, G, Cq, dh = qg.shape
    dev = qg.device
    qpos = torch.arange(Cq, device=dev) + q0
    neg = torch.full((), NEG_INF, device=dev)
    zero = torch.zeros((), device=dev)
    m = torch.full((B, Hkv, G, Cq), NEG_INF, device=dev)
    l = torch.zeros((B, Hkv, G, Cq), device=dev)
    acc = torch.zeros((B, Hkv, G, Cq, dh), device=dev)
    for j in range(k.shape[1] // block_k):
        kblk = k[:, j * block_k:(j + 1) * block_k].float()
        vblk = v[:, j * block_k:(j + 1) * block_k].float()
        s = torch.einsum("bkgqd,bskd->bkgqs", qg, kblk)
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        kpos = j * block_k + torch.arange(block_k, device=dev)
        msk = torch.ones((Cq, block_k), dtype=torch.bool, device=dev)
        if causal:
            msk &= kpos[None, :] <= qpos[:, None]
        if window:
            msk &= kpos[None, :] > qpos[:, None] - window
        s = torch.where(msk, s, neg)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(m_new <= NEG_INF / 2, zero, m_new)
        p = torch.where(msk, torch.exp(s - m_safe[..., None]), zero)
        dead = m <= NEG_INF / 2
        corr = torch.where(dead, zero,
                           torch.exp(torch.where(dead, neg, m) - m_safe))
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p,
                                                   vblk)
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None]


def _split_heads(k: torch.Tensor):
    """The tensor dims q / k / v keep sharded on their ranks: batch, and
    the heads where their split divides the KV heads evenly."""
    def divides(pl) -> tuple:
        split = 1
        for i, p in enumerate(pl):
            split *= k.device_mesh.size(i) if p.is_shard(2) else 1
        return (0,) if k.shape[2] % split else (0, 2)
    return divides


def train_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, block_q: int = 1024,
                    block_k: int = 512) -> torch.Tensor:
    """Differentiable GQA attention over the full sequence, ``q
    [B,Sq,Hq,dh]``, ``k/v [B,Sk,Hkv,dh]`` -> ``[B,Sq,Hq,dh]`` in q's
    dtype: causal, ``window`` > 0 to a sliding window, or with
    ``causal=False`` bidirectional; ``softcap`` > 0 soft-caps each key
    block's scores before its mask, as the reference's. ``block_k`` halves until it divides
    ``Sk`` and ``block_q`` until it divides ``Sq``, as the reference's."""
    if is_dtensor(q):
        (q_, k_, v_), wrap = on_shards((q, k, v), (0, 2),
                                       divides=_split_heads(k))
        return wrap(train_attention(q_, k_, v_, causal=causal,
                                    window=window, softcap=softcap,
                                    block_q=block_q, block_k=block_k),
                    q.shape)
    B, Sq, Hq, dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    while Sk % block_k:
        block_k //= 2
    while Sq % block_q:
        block_q //= 2
    qg = _split_gqa(q, Hkv).float() / torch.sqrt(
        torch.tensor(dh, dtype=torch.float32, device=q.device))
    qg = qg.permute(0, 2, 3, 1, 4)                     # [B,Hkv,G,Sq,dh]
    outs = [checkpoint(_attention_q_chunk,
                       qg[:, :, :, i:i + block_q], k, v, i, causal=causal,
                       window=window, softcap=softcap, block_k=block_k,
                       use_reentrant=False)
            for i in range(0, Sq, block_q)]
    out = torch.cat(outs, 3).permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, dh)
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: int | torch.Tensor,
                     softcap: float = 0.0) -> torch.Tensor:
    """Single-position attention: q [B,1,Hq,dh] vs cache k/v [B,T,Hkv,dh].

    ``length`` (int or ``[B]`` tensor) masks the valid cache prefix. The
    logits ``[B, Hkv, G, T]`` pass ``decode_logits_constraint`` (the
    identity unless a launcher installs it), then the scale and, with
    ``softcap`` > 0, the soft-cap, before the mask.
    """
    B, _, Hq, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qg = _split_gqa(q, Hkv)[:, 0].float()                 # [B,Hkv,G,dh]
    s = decode_logits_constraint(
        torch.einsum("bkgd,btkd->bkgt", qg, k.float())) / math.sqrt(dh)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    tpos = torch.arange(T, device=q.device)[None, :]
    # a host int compares as a scalar: no host-to-device copy per step
    ln = length[:, None] if torch.is_tensor(length) else length
    msk = tpos < ln                                       # [B or 1, T]
    s = torch.where(msk[:, None, None, :], s,
                    torch.full((), NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    return out.reshape(B, 1, Hq, dh).to(q.dtype)
