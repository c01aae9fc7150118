"""Launch wrapper of the CUDA flash-attention forward
(``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``flash_attention_fwd``
(``src/repro/kernels/flash_attention/kernel.py``): GQA prefill attention of
``q [B,Hq,Sq,dh]`` against ``k/v [B,Hkv,Sk,dh]``, the K/V of query head
``h`` read from KV head ``h // G`` (no broadcast copy), causal and
sliding-window masks placed by ``q_offset``, online-softmax statistics in
float32, float32 or bfloat16 in and out.

One block per (batch, query head, tile of 32 query rows) walks the K/V
tiles of 64 keys that its mask can reach, staged in shared memory as
float32; tiles wholly outside the mask are skipped, which leaves the
online-softmax state exactly as the reference's masked update would.
Tensors are passed with their strides (``dh`` contiguous), so the model's
``[B, S, H, dh]`` layout is read in place.

Bound on the H100: operations — ``4 * dh`` flops per unmasked (query,
key) pair per query head, about 0.035 ms at the bf16 tensor-core peak for
jamba's 4 x 1024-token prefill. This first kernel computes on the CUDA
cores in float32 and sits far above that bound; tensor cores (``wgmma``)
are later work.
"""

from __future__ import annotations

import torch

from .. import _build

flash_attention_launches = _build.counter("flash_attention")

_ARGS = ([_build.VP] * 4 + [_build.I32] * 7 + [_build.I64] * 12
         + [_build.I32] * 2 + [_build.F32, _build.I32, _build.VP])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: largest head dim the kernel takes
MAX_HEAD_DIM = 256


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
    fn = _build.bind("flash_attention", "flash_attention_launch", _ARGS)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  B, Hq, Hkv, Sq, Sk, dh, int(bool(causal)), *strides,
                  int(window), int(q_offset),
                  float(sm_scale or 1.0 / dh ** 0.5), _DTYPES[q.dtype],
                  _build.stream_ptr())
    _build.check(code, "flash_attention")
    flash_attention_launches.n += 1
    return o
