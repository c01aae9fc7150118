"""Launch wrapper of the CUDA flash-attention forward
(``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``flash_attention_fwd``
(``src/repro/kernels/flash_attention/kernel.py``): GQA prefill attention of
``q [B,Hq,Sq,dh]`` against ``k/v [B,Hkv,Sk,dh]``, the K/V of query head
``h`` read from KV head ``h // G`` (no broadcast copy), causal and
sliding-window masks placed by ``q_offset``, online-softmax statistics in
float32, float32 or bfloat16 in and out. Tensors are passed with their
strides (``dh`` contiguous), so the model's ``[B, S, H, dh]`` layout is
read in place; K/V tiles that the mask cannot reach are skipped, which
leaves the online-softmax state exactly as the reference's masked update
would.

Two routes, chosen explicitly by :func:`tensor_core_route`:

* **tensor cores** (bfloat16, ``dh <= 160``, views a TMA tensor map takes:
  16-byte aligned bases, strides of whole 16-byte units) — Q and a 2-stage
  K/V ring by TMA on mbarriers in 128-byte-swizzled boxes of 64 columns,
  ``wgmma`` for S = Q K^T and for O += P V with ``P`` carried in three
  bf16 parts (``P_hi + P_mid + P_lo``, three products into one f32
  accumulator), which keeps the result within one bf16 ulp of the f32
  plain version. One warpgroup per 64 query rows up to ``dh`` 128; above
  (stablelm-12b's 160), two warpgroups per 128 query rows sharing each K/V
  stage, so that a block's 144 KB of shared memory still keeps 8 warps
  an SM. Counted by ``flash_attention_wgmma_launches`` as well.
* **CUDA cores** (float32 — TF32 would miss the 2e-5 f32 limit — and the
  bf16 inputs the first route does not take: ``dh`` in (160, 256], or
  views no tensor map takes) — 32 query rows a block on float32 tiles in
  shared memory.

``flash_attention_launches`` counts every launch of either route;
``flash_attention_cuda_core_bf16_launches`` the bf16 launches of the
CUDA-core route. :func:`tensor_core_resources` reads the registers,
spill bytes, shared memory and residency of a tensor-core instantiation.

Bound on the H100: operations — ``4 * dh`` flops per unmasked (query,
key) pair per query head, about 0.035 ms at the bf16 tensor-core peak for
jamba's 4 x 1024-token prefill.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

flash_attention_launches = _build.counter("flash_attention")
flash_attention_wgmma_launches = _build.counter("flash_attention_wgmma")
flash_attention_cuda_core_bf16_launches = _build.counter(
    "flash_attention_cuda_core_bf16")

_ARGS = ([_build.VP] * 4 + [_build.I32] * 7 + [_build.I64] * 12
         + [_build.I32] * 2 + [_build.F32, _build.I32, _build.VP])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TC_ARGS = _ARGS[:-2] + [_build.VP]
#: largest head dim the kernel takes
MAX_HEAD_DIM = 256
#: largest head dim of the tensor-core route
MAX_TC_HEAD_DIM = 160


def _check(q, k, v) -> None:
    ts = (q, k, v)
    if not all(t.is_cuda for t in ts):
        raise ValueError("flash_attention kernel: every input must be a "
                         "CUDA tensor")
    if len({t.device for t in ts}) != 1:
        raise ValueError("flash_attention kernel: inputs on different "
                         "devices")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel: q/k/v must share dtype "
                         f"float32 or bfloat16, got {q.dtype}/{k.dtype}/"
                         f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention kernel: bad shapes q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    B, Hq, _, dh = q.shape
    if k.shape[0] != B or k.shape[3] != dh or Hq % k.shape[1]:
        raise ValueError(f"flash_attention kernel: k/v {tuple(k.shape)} do "
                         f"not fit q {tuple(q.shape)}")
    if not 0 < dh <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel: head dim {dh} not in "
                         f"(0, {MAX_HEAD_DIM}]")
    if any(t.stride(3) != 1 for t in ts):
        raise ValueError("flash_attention kernel: the head dim must be "
                         "contiguous")


def _tma_view(t: torch.Tensor) -> bool:
    """A tensor map takes ``t [B,H,S,dh]``: 16-byte aligned base, and every
    stride of a dim longer than 1 a whole number of 16-byte units."""
    return t.data_ptr() % 16 == 0 and all(
        st % 8 == 0 for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1)


def tensor_core_route(q, k, v) -> bool:
    """Whether the tensor-core kernel takes these inputs: bfloat16, head
    dim at most :data:`MAX_TC_HEAD_DIM`, and views a TMA tensor map takes.
    Every other input goes to the CUDA-core kernel."""
    return (q.dtype == torch.bfloat16 and q.shape[3] <= MAX_TC_HEAD_DIM
            and _tma_view(q) and _tma_view(k) and _tma_view(v))


def tensor_core_resources(dh: int) -> dict:
    """Registers and local (spill) bytes a thread, dynamic shared bytes,
    threads a block and blocks resident an SM of the tensor-core
    instantiation that takes head dim ``dh``, as the CUDA runtime reports
    them for the current card."""
    if not 0 < dh <= MAX_TC_HEAD_DIM:
        raise ValueError(f"flash_attention kernel: head dim {dh} not in "
                         f"(0, {MAX_TC_HEAD_DIM}]")
    fn = _build.bind("flash_attention", "flash_attention_wgmma_resources",
                     [_build.I32, ctypes.POINTER(ctypes.c_int)])
    out = (ctypes.c_int * 5)()
    _build.check(fn(dh, out), "flash_attention_wgmma_resources")
    return dict(zip(("registers", "local_bytes", "shared_bytes", "threads",
                     "blocks_per_sm"), out))


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, sm_scale: float | None = None
                        ) -> torch.Tensor:
    """q [B,Hq,Sq,dh], k/v [B,Hkv,Sk,dh] (any strides with ``dh``
    contiguous) -> o [B,Hq,Sq,dh] laid out as q. ``sm_scale`` defaults to
    ``1 / sqrt(dh)``."""
    _check(q, k, v)
    B, Hq, Sq, dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)           # q's strides, dh contiguous as in q
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Hq,
            Hkv, Sq, Sk, dh, int(bool(causal)), *strides, int(window),
            int(q_offset), float(sm_scale or 1.0 / dh ** 0.5)]
    if tensor_core_route(q, k, v):
        name = "flash_attention_wgmma_launch"
        fn = _build.bind("flash_attention", name, _TC_ARGS)
        code = _build.launch(fn, q.get_device(), *args)
        counted = (flash_attention_launches, flash_attention_wgmma_launches)
    else:
        name = "flash_attention_launch"
        fn = _build.bind("flash_attention", name, _ARGS)
        code = _build.launch(fn, q.get_device(), *args, _DTYPES[q.dtype])
        counted = (flash_attention_launches,) + (
            (flash_attention_cuda_core_bf16_launches,)
            if q.dtype == torch.bfloat16 else ())
    _build.check(code, name)
    for c in counted:
        c.n += 1
    return o
