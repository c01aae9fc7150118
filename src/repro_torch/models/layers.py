"""Shared layers: RMSNorm / LayerNorm, RoPE / M-RoPE, the SwiGLU / GeGLU
MLP, the chunked cross-entropy, and the parameter inits.

Counterpart of ``repro.models.layers``.
Weights keep the reference's orientation, ``[d_in, d_out]`` applied as
``x @ w``, so a converted weight is the reference's array as it is.
Compute dtype discipline as there: matmuls run in the parameter dtype;
norms and rotary compute in float32 and cast back. The inits draw from an
explicit ``torch.Generator``; they follow the reference's distributions,
not its ``jax.random`` bits. GELU is the tanh form, as ``jax.nn.gelu``'s
default (``approximate=True``). :func:`chunked_ce_loss` is the training
loss of ``Transformer.train_forward``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.activations import replicate


# --------------------------------------------------------------------------
# param inits (in place, from a generator on the tensor's device)
# --------------------------------------------------------------------------
def dense_init_(w: torch.Tensor, gen: torch.Generator,
                scale: float | None = None) -> torch.Tensor:
    """Truncated normal on [-2, 2] at fan-in scale ``1/sqrt(d_in)`` for a
    ``[d_in, d_out]`` weight, drawn in float32 and cast to ``w``'s dtype.

    A stacked ``[E, d_in, d_out]`` weight (the MoE experts; pass
    ``scale``) is drawn one ``[d_in, d_out]`` slice at a time through one
    float32 buffer of that size, so the temporary stays a slice's bytes
    (0.17 GB for llama4-maverick's experts, against 21.5 GB for the
    whole stack)."""
    scale = 1.0 / math.sqrt(w.shape[0]) if scale is None else scale
    f = torch.empty(w.shape[-2:], dtype=torch.float32, device=w.device)
    with torch.no_grad():
        for part in (w,) if w.dim() < 3 else w:
            torch.nn.init.trunc_normal_(f, 0.0, 1.0, -2.0, 2.0,
                                        generator=gen)
            part.copy_(f.mul_(scale))
    return w


def embed_init_(w: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """N(0, 0.02) for a ``[vocab, d]`` table, drawn in float32."""
    f = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    torch.nn.init.normal_(f, 0.0, 1.0, generator=gen)
    with torch.no_grad():
        w.copy_(f * 0.02)
    return w


def norm_init_(scale: torch.Tensor,
               bias: torch.Tensor | None = None) -> torch.Tensor:
    """Scale 1 and (LayerNorm) bias 0."""
    with torch.no_grad():
        if bias is not None:
            bias.zero_()
        return scale.fill_(1.0)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
def apply_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5,
               bias: torch.Tensor | None = None) -> torch.Tensor:
    """RMSNorm, or LayerNorm when ``bias`` is given, in float32, cast back
    to ``x``'s dtype (the bias is added before the scale, as the
    reference's ``apply_norm(kind="layernorm")``)."""
    xf = x.float()
    if bias is None:
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    else:
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps) + bias.float()
    return (y * scale.float()).to(x.dtype)


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------
def _freqs(half: int, theta: float, device) -> torch.Tensor:
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    # a host scalar base: no host-to-device copy per decode step
    return torch.pow(float(theta), exps)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> torch.Tensor:
    """positions [...] -> angles [..., head_dim // 2] (float32)."""
    freqs = _freqs(head_dim // 2, theta, positions.device)
    return positions.float()[..., None] * freqs


def mrope_angles(positions3: torch.Tensor, head_dim: int, theta: float,
                 sections: tuple[int, int, int]) -> torch.Tensor:
    """M-RoPE (qwen2-vl): positions3 [3, ...] (t, h, w ids) -> angles
    [..., head_dim // 2] (float32).

    The ``head_dim // 2`` frequency slots split into ``sections`` (t, h,
    w), each slice rotated by its own coordinate. Text tokens carry t == h
    == w, where the angles equal :func:`rope_angles`' bitwise (the same
    frequencies times the same float position)."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"head_dim // 2 = {half}")
    freqs = _freqs(half, theta, positions3.device)
    sel = torch.repeat_interleave(
        torch.arange(3, device=positions3.device),
        torch.tensor(sections, device=positions3.device),
        output_size=half)                                   # slot -> coord
    coord = torch.movedim(positions3, 0, -1).float()         # [..., 3]
    return coord[..., sel] * freqs


def apply_rotary(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x [..., h, d]; angles broadcastable to [..., 1, d//2]. Pairs
    (i, i + d/2), in float32."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    c, s = torch.cos(angles), torch.sin(angles)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(x.dtype)


# --------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU)
# --------------------------------------------------------------------------
def activation(act: str):
    """``"silu"`` or ``"gelu"`` (tanh form, as ``jax.nn.gelu``)."""
    if act == "silu":
        return F.silu
    if act == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {act!r}")


def apply_mlp(wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
              x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """``(act(x @ wg) * (x @ wu)) @ wd`` in the parameter dtype."""
    return (activation(act)(x @ wg) * (x @ wu)) @ wd


# --------------------------------------------------------------------------
# chunked cross-entropy (bounded logits footprint)
# --------------------------------------------------------------------------
def _chunk_nll(h: torch.Tensor, w_out: torch.Tensor, t: torch.Tensor,
               m: torch.Tensor) -> torch.Tensor:
    """Masked NLL summed over one chunk; its ``[B, C, V]`` logits in
    float32 (the product in the hidden dtype, then cast). On
    vocab-sharded DTensor logits the gathered target logits are
    replicated before the select (``distributed.activations.replicate``):
    DTensor's masked partial of a gather is mis-reduced after it."""
    logits = (h @ w_out).float()
    lse = torch.logsumexp(logits, -1)
    gold = replicate(torch.gather(logits, -1, t[..., None].long()))[..., 0]
    return ((lse - gold) * m).sum()


def chunked_ce_loss(hidden: torch.Tensor, w_out: torch.Tensor,
                    targets: torch.Tensor, mask: torch.Tensor,
                    n_chunks: int = 0) -> torch.Tensor:
    """Mean CE over ``[B, S]`` targets without materialising ``[B, S, V]``
    logits: ``hidden [B, S, D]`` through ``w_out [D, V]`` in chunks of the
    sequence, each under ``torch.utils.checkpoint`` so that backward
    recomputes its logits instead of keeping them; the float32 sums
    accumulate chunk by chunk, as the reference's scan carries them. The
    reference's chunk count: ``n_chunks``, or with 0 enough that a chunk
    holds about 2^28 logits, between 8 and 32; at most ``S``, then shrunk
    to a divisor of ``S``."""
    B, S, _ = hidden.shape
    if n_chunks <= 0:
        n_chunks = max(8, min(32, (B * S * w_out.shape[1] + (1 << 28) - 1)
                               >> 28))
    n = min(n_chunks, S)
    while S % n:
        n -= 1
    C = S // n
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n):
        sl = slice(i * C, (i + 1) * C)
        m = mask[:, sl].float()
        tot = tot + checkpoint(_chunk_nll, hidden[:, sl], w_out,
                               targets[:, sl], m, use_reentrant=False)
        cnt = cnt + m.sum()
    return tot / torch.clamp(cnt, min=1.0)
