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

Three routes, chosen in one place, :func:`route`:

* ``"wgmma"`` (bfloat16, ``dh <= 256``, views a TMA tensor map takes:
  16-byte aligned bases, strides of whole 16-byte units) — Q and a 2-stage
  K/V ring by TMA on mbarriers in 128-byte-swizzled boxes of 64 columns,
  ``wgmma`` for S = Q K^T and for O += P V with ``P`` carried in three
  bf16 parts (``P_hi + P_mid + P_lo``, three products into one f32
  accumulator), which keeps the result within one bf16 ulp of the f32
  plain version. One warpgroup per 64 query rows up to ``dh`` 128; above
  (stablelm-12b's 160, and up to 256), two warpgroups per 128 query rows
  sharing each K/V stage, so that a block of 144 KB (192 KB at 256) still
  keeps 8 warps an SM. Counted by ``flash_attention_wgmma_launches`` as
  well.
* ``"split_f32"`` (float32, ``dh <= 128``, views a tensor map takes) —
  :func:`split_bf16x3` writes each of q, k, v as three bf16 parts (hi,
  mid, lo: they sum back to x bitwise), a scratch of 1.5x the f32 bytes of
  q, k and v; the attention kernel forms S and O from the six part
  products whose parts sum to at most 2 (the dropped ones are at most
  about 2^-24 of a product), on 32-key tiles. Held to the f32 limit, 2e-5
  absolute. Counted by ``flash_attention_split_f32_launches`` as well
  (the split passes by ``split_bf16x3_launches``).
* ``"cuda_core"`` (float32 with ``dh`` in (128, 256], and either dtype on
  views no tensor map takes) — 32 query rows a block on float32 tiles in
  shared memory. Counted by ``flash_attention_cuda_core_bf16_launches`` or
  ``flash_attention_cuda_core_f32_launches`` as well.

``flash_attention_launches`` counts every attention launch of any route.
:func:`tensor_core_resources` reads the registers, spill bytes, shared
memory and residency of a tensor-core instantiation. A CUDA tensor never
leaves its kernel: a failed build or launch raises, with no fallback to
another route or to the plain version.

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
flash_attention_split_f32_launches = _build.counter(
    "flash_attention_split_f32")
flash_attention_cuda_core_bf16_launches = _build.counter(
    "flash_attention_cuda_core_bf16")
flash_attention_cuda_core_f32_launches = _build.counter(
    "flash_attention_cuda_core_f32")
split_bf16x3_launches = _build.counter("split_bf16x3")

_ARGS = ([_build.VP] * 4 + [_build.I32] * 7 + [_build.I64] * 12
         + [_build.I32] * 2 + [_build.F32, _build.I32, _build.VP])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SPLIT_ARGS = ([_build.VP] * 2 + [_build.I32] * 5 + [_build.I64] * 3
               + [_build.VP])
#: largest head dim the kernel takes
MAX_HEAD_DIM = 256
#: the padded head dims (DHP) of each tensor-core route's instantiations;
#: the last is the largest head dim the route takes
TILES = {"wgmma": (64, 80, 128, 160, 192, 256), "split_f32": (64, 128)}
_TC_ROUTE = {torch.bfloat16: "wgmma", torch.float32: "split_f32"}
_ENTRY = {"wgmma": "flash_attention_wgmma_launch",
          "split_f32": "flash_attention_split_f32_launch"}


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
    isz = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        st * isz % 16 == 0 for n, st in zip(t.shape[:3], t.stride()[:3])
        if n > 1)


def route(q, k, v) -> str:
    """The route that takes these inputs: ``"wgmma"`` (bfloat16, head dim
    at most 256) and ``"split_f32"`` (float32, head dim at most 128), each
    only on views a TMA tensor map takes (:data:`TILES`), and
    ``"cuda_core"`` for every other input."""
    name = _TC_ROUTE.get(q.dtype)
    if (name is not None and q.shape[3] <= TILES[name][-1]
            and _tma_view(q) and _tma_view(k) and _tma_view(v)):
        return name
    return "cuda_core"


def tensor_core_route(q, k, v) -> bool:
    """Whether these inputs run on the tensor cores (:func:`route` is
    ``"wgmma"`` or ``"split_f32"``)."""
    return route(q, k, v) != "cuda_core"


def route_counter(name: str, dtype) -> _build.LaunchCount:
    """The counter that a launch on route ``name`` in ``dtype`` raises
    besides ``flash_attention_launches``."""
    if name == "cuda_core":
        return (flash_attention_cuda_core_bf16_launches
                if dtype == torch.bfloat16
                else flash_attention_cuda_core_f32_launches)
    return {"wgmma": flash_attention_wgmma_launches,
            "split_f32": flash_attention_split_f32_launches}[name]


def tile_width(name: str, dh: int) -> int:
    """The padded head dim (DHP) of route ``name``'s instantiation that
    takes head dim ``dh``: the narrowest of ``TILES[name]`` at least
    ``dh``."""
    for w in TILES[name]:
        if 0 < dh <= w:
            return w
    raise ValueError(f"flash_attention kernel: head dim {dh} not in (0, "
                     f"{TILES[name][-1]}] of the {name} route")


def tensor_core_resources(dh: int, dtype=torch.bfloat16) -> dict:
    """Registers and local (spill) bytes a thread, dynamic shared bytes,
    threads a block and blocks resident an SM of the tensor-core
    instantiation that takes head dim ``dh`` in ``dtype`` (bfloat16: the
    wgmma route; float32: the split route), as the CUDA runtime reports
    them for the current card."""
    name = _TC_ROUTE[dtype]
    dhp = tile_width(name, dh)
    fn = _build.bind("flash_attention", "flash_attention_wgmma_resources",
                     [_build.I32, _build.I32, ctypes.POINTER(ctypes.c_int)])
    out = (ctypes.c_int * 5)()
    _build.check(fn(dhp, int(name == "split_f32"), out),
                 "flash_attention_wgmma_resources")
    return dict(zip(("registers", "local_bytes", "shared_bytes", "threads",
                     "blocks_per_sm"), out))


def split_bf16x3(x: torch.Tensor) -> torch.Tensor:
    """x [B,H,S,dh] float32 on the card (``dh`` contiguous, any other
    strides) -> its three bfloat16 parts ``[3,B,H,S,dh]``: hi = bf16(x),
    mid = bf16(x - hi), lo = bf16(x - hi - mid). A view of a contiguous
    ``[3,B,H,S,dhp]`` buffer, ``dhp`` = ``dh`` rounded up to 8, so that
    every row starts on a 16-byte boundary (the columns past ``dh`` are
    0). Plain version: ``ref.split_bf16x3_ref``."""
    if not x.is_cuda or x.dtype != torch.float32 or x.dim() != 4:
        raise ValueError(f"split_bf16x3: want a 4-D float32 CUDA tensor, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if x.stride(3) != 1:
        raise ValueError("split_bf16x3: the last dim must be contiguous")
    B, H, S, dh = x.shape
    dhp = -(-dh // 8) * 8
    out = torch.empty((3, B, H, S, dhp), dtype=torch.bfloat16,
                      device=x.device)
    fn = _build.bind("flash_attention", "split_bf16x3_launch", _SPLIT_ARGS)
    code = _build.launch(fn, x.get_device(), x.data_ptr(), out.data_ptr(),
                         B, H, S, dh, dhp, *x.stride()[:3])
    _build.check(code, "split_bf16x3_launch")
    split_bf16x3_launches.n += 1
    return out[..., :dh]


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
    scale = float(sm_scale or 1.0 / dh ** 0.5)
    which = route(q, k, v)
    if which == "split_f32":           # the parts as batches p * B + b
        q, k, v = (split_bf16x3(t).flatten(0, 1) for t in (q, k, v))
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Hq,
            Hkv, Sq, Sk, dh, int(bool(causal)), *strides, int(window),
            int(q_offset), scale]
    if which == "cuda_core":
        name = "flash_attention_launch"
        fn = _build.bind("flash_attention", name, _ARGS)
        code = _build.launch(fn, o.get_device(), *args, _DTYPES[o.dtype])
    else:
        name = _ENTRY[which]
        fn = _build.bind("flash_attention", name,
                         _ARGS[:-2] + [_build.I32, _build.VP])
        code = _build.launch(fn, o.get_device(), *args,
                             tile_width(which, dh))
    _build.check(code, name)
    flash_attention_launches.n += 1
    route_counter(which, o.dtype).n += 1
    return o
