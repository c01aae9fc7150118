"""Launch wrapper of the CUDA selective scan (``csrc/selective_scan.cu``).

Replaces the Pallas TPU kernel ``selective_scan_fwd``
(``src/repro/kernels/selective_scan/kernel.py``), the Mamba S6 forward
``h_t = exp(dt_t * a) * h_{t-1} + (dt_t * x_t) * b_t``,
``y_t = sum_N h_t * c_t`` with ``h_0 = 0``, in float32.

The TPU kernel keeps ``h`` in VMEM across a sequential time grid; here two
consumer lanes per (sequence, channel) keep its N states in registers, half
each, and walk the whole sequence, reading only shared memory: a producer
warp keeps a ring of staged tiles of time steps of ``dt``, ``x``, ``b`` and
``c`` filled ahead of the walk (:func:`ring_shape`). The even
lane hands its partial sum over the first N/2 states to the odd lane, which
continues it in order. Channels are independent, so blocks need no
communication. The arithmetic is the plain version's op for op, so ``y``
and ``h_final`` are bitwise equal to it.

Inputs are taken as the model holds them, as the Pallas kernel does:
``x`` float32 or bfloat16 (converted in the kernel), ``b`` / ``c`` through
their row strides (views of one projection), every tensor with a unit
inner stride. Two routes, chosen explicitly by :func:`tma_route` from the
shapes, dtypes, strides and alignment alone:

* **TMA** — 3-D tensor maps (column, time, sequence), one elected producer
  thread, mbarrier completion. Counted by ``selective_scan_tma_launches``
  as well.
* **cp.async** — every other view :func:`check_inputs` takes (rows of 20
  bytes at ``di = 5``, ``N < 4``, unaligned bases): the producer warp's
  lanes copy element by element.

``selective_scan_launches`` counts every launch of either route. A view
neither route takes raises; nothing falls back.

Bound on the H100: instruction issue — 12 issue slots a state update (the
accurate ``expf``, the multiply / adds fused), 0.19 ms at jamba's prefill
of 4 x 1024 tokens, di 8192, N 16; the bytes (``dt``, ``x``, ``y`` once
each) take 0.10 ms.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

selective_scan_launches = _build.counter("selective_scan")
selective_scan_tma_launches = _build.counter("selective_scan_tma")

_ARGS = ([_build.VP] * 7 + [_build.I32] * 6 + [_build.I64] * 8
         + [_build.VP])
#: state sizes the kernel is compiled for (N states per thread in registers)
N_SUPPORTED = (1, 2, 4, 8, 16, 32, 64)
#: dtypes ``x`` is taken in; ``dt``, ``b``, ``c`` and ``a`` are float32
X_DTYPES = (torch.float32, torch.bfloat16)


def ring_shape() -> tuple[int, int]:
    """(time steps a ring stage holds, stages), as ``csrc/selective_scan.cu``
    defines them; loads the library (a CUDA machine only)."""
    tt, stages = ctypes.c_int(), ctypes.c_int()
    fn = _build.bind("selective_scan", "selective_scan_ring",
                     [ctypes.POINTER(ctypes.c_int)] * 2)
    fn(ctypes.byref(tt), ctypes.byref(stages))
    return tt.value, stages.value


def _unit_inner(t: torch.Tensor) -> bool:
    return t.shape[-1] == 1 or t.stride(-1) == 1


def check_inputs(dt, b, c, x, a) -> None:
    """Raise ``ValueError`` unless the kernel takes these tensors (any
    device): ``dt/x [B,S,di]``, ``b/c [B,S,N]``, ``a [di,N]``; ``dt``,
    ``b``, ``c``, ``a`` float32 and ``x`` float32 or bfloat16; ``N`` in
    :data:`N_SUPPORTED`; a unit inner stride on ``dt``, ``x``, ``b``, ``c``
    and ``a`` contiguous."""
    if any(t.dim() != 3 for t in (dt, b, c, x)) or a.dim() != 2:
        raise ValueError("selective_scan kernel: dt/b/c/x must be 3-D and "
                         "a 2-D")
    if any(t.dtype != torch.float32 for t in (dt, b, c, a)):
        raise ValueError("selective_scan kernel: dt, b, c and a must be "
                         "float32")
    if x.dtype not in X_DTYPES:
        raise ValueError(f"selective_scan kernel: x must be float32 or "
                         f"bfloat16, got {x.dtype}")
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
    if not all(_unit_inner(t) for t in (dt, b, c, x)):
        raise ValueError("selective_scan kernel: dt, b, c and x need a unit "
                         "stride on their last dim")
    if not a.is_contiguous():
        raise ValueError("selective_scan kernel: a must be contiguous")


def _tma_view(t: torch.Tensor) -> bool:
    """A 3-D tensor map takes ``t [B,S,w]`` (unit inner stride): a 16-byte
    aligned base, and the stride of each of its first two dims longer than
    1 a whole number of 16-byte units that does not overlap the dims
    inside it."""
    B, S, w = t.shape
    es = t.element_size()
    row, seq = t.stride(1) * es, t.stride(0) * es
    ok = t.data_ptr() % 16 == 0
    if S > 1:
        ok = ok and row % 16 == 0 and row >= w * es
    if B > 1:
        inner = row * S if S > 1 else w * es
        ok = ok and seq % 16 == 0 and seq >= inner
    return ok


def tma_route(dt, b, c, x) -> bool:
    """Whether the TMA route takes these (already checked) inputs: at least
    one time step, ``N >= 4`` (a box row of 16 bytes or more), and views a
    tensor map takes. Every other input goes to the cp.async route."""
    return (dt.shape[1] > 0 and b.shape[-1] >= 4
            and all(_tma_view(t) for t in (dt, x, b, c)))


def selective_scan_fwd(dt, b, c, x, a) -> tuple[torch.Tensor, torch.Tensor]:
    """dt/x [B,S,di], b/c [B,S,N], a [di,N] as :func:`check_inputs` takes
    them, on one CUDA device -> (y [B,S,di], h_final [B,di,N]) float32."""
    ts = (dt, b, c, x, a)
    if not all(t.is_cuda for t in ts):
        raise ValueError("selective_scan kernel: every input must be a CUDA "
                         "tensor")
    if len({t.device for t in ts}) != 1:
        raise ValueError("selective_scan kernel: inputs on different devices")
    check_inputs(dt, b, c, x, a)
    B, S, di = dt.shape
    N = a.shape[-1]
    y = torch.empty((B, S, di), dtype=torch.float32, device=dt.device)
    h = torch.empty((B, di, N), dtype=torch.float32, device=dt.device)
    tma = tma_route(dt, b, c, x)
    strides = [s for t in (dt, x, b, c) for s in t.stride()[:2]]
    fn = _build.bind("selective_scan", "selective_scan_launch", _ARGS)
    code = _build.launch(fn, dt.get_device(), dt.data_ptr(), b.data_ptr(),
                         c.data_ptr(), x.data_ptr(), a.data_ptr(),
                         y.data_ptr(), h.data_ptr(), B, S, di, N,
                         int(x.dtype == torch.bfloat16), int(tma),
                         *strides)
    _build.check(code, "selective_scan")
    selective_scan_launches.n += 1
    if tma:
        selective_scan_tma_launches.n += 1
    return y, h
