"""Selective scan: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors (or when the caller opts out)."""

from __future__ import annotations

from .kernel import selective_scan_fwd
from .ref import _scan


def selective_scan(dt, b, c, x, a, *, use_kernel: bool = True,
                   return_state: bool = False):
    """dt/x [B,S,di], b/c [B,S,N], a [di,N] -> y [B,S,di] (dt's dtype), and
    with ``return_state`` also the float32 decode carry ``h_S [B,di,N]``
    (``h_0 = 0``). A CUDA ``dt`` goes through the kernel (or raises)."""
    if use_kernel and dt.is_cuda:
        y, h = selective_scan_fwd(*(t.float().contiguous()
                                    for t in (dt, b, c, x, a)))
    else:
        y, h = _scan(dt, b, c, x, a)
    y = y.to(dt.dtype)
    return (y, h) if return_state else y
