"""Launch wrapper of the CUDA selective scan (``csrc/selective_scan.cu``).

Replaces the Pallas TPU kernel ``selective_scan_fwd``
(``src/repro/kernels/selective_scan/kernel.py``), the Mamba S6 forward
``h_t = exp(dt_t * a) * h_{t-1} + (dt_t * x_t) * b_t``,
``y_t = sum_N h_t * c_t`` with ``h_0 = 0``, all in float32.

The TPU kernel keeps ``h`` in VMEM across a sequential time grid; here one
thread per (sequence, channel) keeps its N states in registers and walks
the whole sequence, with each time tile of ``b`` / ``c`` (shared by every
channel of the sequence) staged in shared memory. Channels are
independent, so blocks need no communication.

Bound on the H100: memory — ``dt``, ``x`` and ``y`` ``[B,S,di]`` once
each, ``b`` / ``c`` ``[B,S,N]``, ``a`` and ``h_final`` (about 0.12 ms at
jamba's prefill of 4 x 1024 tokens, di 8192, N 16); the serial walk over
S per thread leaves it latency-bound well above that.
"""

from __future__ import annotations

import torch

from .. import _build

selective_scan_launches = _build.counter("selective_scan")

_ARGS = [_build.VP] * 7 + [_build.I32] * 4 + [_build.VP]
#: state sizes the kernel is compiled for (N states per thread in registers)
N_SUPPORTED = (1, 2, 4, 8, 16, 32, 64)


def _check(dt, b, c, x, a) -> None:
    ts = (dt, b, c, x, a)
    if not all(t.is_cuda for t in ts):
        raise ValueError("selective_scan kernel: every input must be a CUDA "
                         "tensor")
    if len({t.device for t in ts}) != 1:
        raise ValueError("selective_scan kernel: inputs on different devices")
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError("selective_scan kernel: inputs must be float32")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("selective_scan kernel: inputs must be contiguous")
    B, S, di = dt.shape
    N = a.shape[-1]
    if (x.shape != dt.shape or b.shape != (B, S, N) or c.shape != (B, S, N)
            or a.shape != (di, N)):
        raise ValueError(f"selective_scan kernel: bad shapes dt "
                         f"{tuple(dt.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)}, x {tuple(x.shape)}, a "
                         f"{tuple(a.shape)}")
    if N not in N_SUPPORTED:
        raise ValueError(f"selective_scan kernel: d_state {N} not in "
                         f"{N_SUPPORTED}")


def selective_scan_fwd(dt, b, c, x, a) -> tuple[torch.Tensor, torch.Tensor]:
    """dt/x [B,S,di], b/c [B,S,N], a [di,N], all float32 and contiguous
    -> (y [B,S,di], h_final [B,di,N]) float32."""
    _check(dt, b, c, x, a)
    B, S, di = dt.shape
    N = a.shape[-1]
    y = torch.empty_like(dt)
    h = torch.empty((B, di, N), dtype=torch.float32, device=dt.device)
    fn = _build.bind("selective_scan", "selective_scan_launch", _ARGS)
    code = _build.launch(fn, dt.get_device(), dt.data_ptr(), b.data_ptr(),
                         c.data_ptr(), x.data_ptr(), a.data_ptr(),
                         y.data_ptr(), h.data_ptr(), B, S, di, N)
    _build.check(code, "selective_scan")
    selective_scan_launches.n += 1
    return y, h
