"""Selective scan: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors (or when the caller opts out)."""

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
    if use_kernel and dt.is_cuda:
        y, h = selective_scan_fwd(*_kernel_views(dt, b, c, x, a))
    else:
        y, h = _scan(dt, b, c, x, a)
    y = y.to(dt.dtype)
    return (y, h) if return_state else y
