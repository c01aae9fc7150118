"""Selective scan: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors (or when the caller opts out).

Forward-only, as the reference's kernel: under grad mode an input that
requires grad raises on either device, since the kernel's output would be
cut from the autograd graph without a word. The Mamba mixer's training
route is ``repro_torch.models.mamba.apply_mamba_train``.
"""

from __future__ import annotations

import torch

from .kernel import X_DTYPES, selective_scan_fwd
from .ref import _scan


def _kernel_views(dt, b, c, x, a):
    """The inputs as the kernel takes them. The model's own (f32 ``dt``,
    f32 or bf16 ``x``, ``b`` / ``c`` strided views of one projection, a
    contiguous ``a``) pass as they are; any other dtype is cast to f32 and
    a view without a unit inner stride copied, explicitly, here."""
    f32 = lambda t: t if t.dtype == torch.float32 else t.float()
    dt, b, c, a = map(f32, (dt, b, c, a))
    if x.dtype not in X_DTYPES:
        x = x.float()
    unit = lambda t: t if t.shape[-1] == 1 or t.stride(-1) == 1 \
        else t.contiguous()
    return (*map(unit, (dt, b, c, x)), a.contiguous())


def selective_scan(dt, b, c, x, a, *, use_kernel: bool = True,
                   return_state: bool = False):
    """dt/x [B,S,di], b/c [B,S,N], a [di,N] -> y [B,S,di] (dt's dtype), and
    with ``return_state`` also the float32 decode carry ``h_S [B,di,N]``
    (``h_0 = 0``). A CUDA ``dt`` goes through the kernel (or raises)."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (dt, b, c, x, a)):
        raise RuntimeError(
            "selective_scan is forward-only: an input requires grad under "
            "grad mode, and the output would be cut from the autograd "
            "graph; train through repro_torch.models.mamba."
            "apply_mamba_train (Transformer.train_forward)")
    if use_kernel and dt.is_cuda:
        y, h = selective_scan_fwd(*_kernel_views(dt, b, c, x, a))
    else:
        y, h = _scan(dt, b, c, x, a)
    y = y.to(dt.dtype)
    return (y, h) if return_state else y
