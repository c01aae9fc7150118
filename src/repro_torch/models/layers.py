"""Shared layers: RMSNorm, RoPE, SwiGLU MLP, and the parameter inits.

Counterpart of ``repro.models.layers``, for what the dense family the port
builds uses. Weights keep the reference's orientation, ``[d_in, d_out]``
applied as ``x @ w``, so a converted weight is the reference's array as it
is. Compute dtype discipline as there: matmuls run in the parameter dtype;
norms and rotary compute in float32 and cast back. The inits draw from an
explicit ``torch.Generator``; they follow the reference's distributions,
not its ``jax.random`` bits. LayerNorm, GeGLU, M-RoPE and the chunked
cross-entropy wait for the slices that need them (ROADMAP queue 1 items
3-4).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


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


def norm_init_(scale: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return scale.fill_(1.0)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
def apply_norm(scale: torch.Tensor, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in float32, cast back to ``x``'s dtype."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------
def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> torch.Tensor:
    """positions [...] -> angles [..., head_dim // 2] (float32)."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    # a host scalar base: no host-to-device copy per decode step
    freqs = torch.pow(float(theta), exps)
    return positions.float()[..., None] * freqs


def apply_rotary(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x [..., h, d]; angles broadcastable to [..., 1, d//2]. Pairs
    (i, i + d/2), in float32."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    c, s = torch.cos(angles), torch.sin(angles)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(x.dtype)


# --------------------------------------------------------------------------
# MLP (SwiGLU)
# --------------------------------------------------------------------------
def apply_mlp(wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """``(silu(x @ wg) * (x @ wu)) @ wd`` in the parameter dtype."""
    return (F.silu(x @ wg) * (x @ wu)) @ wd
