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

Two routes, both on the tensor cores, chosen in one place, :func:`route`:

* ``"wgmma"`` (bfloat16, ``dh <= 256``) — Q and a 2-stage K/V ring by TMA
  on mbarriers in 128-byte-swizzled boxes of 64 columns, ``wgmma`` for S =
  Q K^T and for O += P V with ``P`` carried in three bf16 parts (``P_hi +
  P_mid + P_lo``, three products into one f32 accumulator), which keeps
  the result within one bf16 ulp of the f32 plain version. One warpgroup
  per 64 query rows up to ``dh`` 128; above (stablelm-12b's 160, and up to
  256), two warpgroups per 128 query rows sharing each K/V stage, so that
  a block of 144 KB (192 KB at 256) still keeps 8 warps an SM. An operand
  no TMA tensor map takes (:func:`packed`: a base off a 16-byte boundary,
  or a stride that is not whole 16-byte units) is first copied by
  :func:`pack_bf16` into a contiguous buffer of its bytes with rows padded
  to 16-byte units, freed after the call. Counted by
  ``flash_attention_wgmma_launches`` as well (the packs by
  ``pack_bf16_launches``).
* ``"split_f32"`` (float32, ``dh <= 256``, any view) — :func:`split_bf16x3`
  writes each of q, k, v as three bf16 parts (hi, mid, lo: they sum back to
  x bitwise), a scratch of 1.5x the f32 bytes of q, k and v; the attention
  kernel forms S and O from the six part products whose parts sum to at
  most 2 (the dropped ones are at most about 2^-24 of a product), on
  32-key tiles up to ``dh`` 192 and 16-key tiles above. Held to the f32
  limit, 2e-5 absolute. Counted by ``flash_attention_split_f32_launches``
  as well (the split passes by ``split_bf16x3_launches``).

Attention logit soft-capping (``softcap`` > 0: each scaled score becomes
``softcap * tanh(s / softcap)`` before the mask, as the reference model's
``attn_logit_softcap``) runs in the same kernel on either route, as the
instantiations of ``csrc/flash_attention_softcap.cu`` (a library of its
own, built beside the cap-free one; one ``tanhf`` a score), counted by
``flash_attention_softcap_launches`` as well. The cap-free instantiations
are compiled as they were.

``flash_attention_launches`` counts every attention launch of either
route. :func:`tensor_core_resources` reads the registers, spill bytes,
shared memory and residency of an instantiation. A CUDA tensor never
leaves its kernels: a failed build or launch of a pack, a split or the
attention raises, with no fallback to the plain version.

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
split_bf16x3_launches = _build.counter("split_bf16x3")
pack_bf16_launches = _build.counter("pack_bf16")
flash_attention_softcap_launches = _build.counter("flash_attention_softcap")

_ARGS = ([_build.VP] * 4 + [_build.I32] * 7 + [_build.I64] * 12
         + [_build.I32] * 2 + [_build.F32, _build.F32, _build.I32,
                               _build.VP])
_SPLIT_ARGS = ([_build.VP] * 2 + [_build.I32] * 5 + [_build.I64] * 3
               + [_build.VP])
#: largest head dim the kernel takes
MAX_HEAD_DIM = 256
#: the padded head dims (DHP) of each tensor-core route's instantiations;
#: the last is the largest head dim the route takes
TILES = {"wgmma": (64, 80, 128, 160, 192, 256),
         "split_f32": (64, 128, 192, 256)}
_TC_ROUTE = {torch.bfloat16: "wgmma", torch.float32: "split_f32"}
_ENTRY = {"wgmma": "flash_attention_wgmma_launch",
          "split_f32": "flash_attention_split_f32_launch"}
_COUNTER = {"wgmma": flash_attention_wgmma_launches,
            "split_f32": flash_attention_split_f32_launches}
#: the library of the attention kernels, by whether they soft-cap
_LIB = {False: "flash_attention", True: "flash_attention_softcap"}


def _check(q, k, v) -> None:
    ts = (q, k, v)
    if not all(t.is_cuda for t in ts):
        raise ValueError("flash_attention kernel: every input must be a "
                         "CUDA tensor")
    if len({t.device for t in ts}) != 1:
        raise ValueError("flash_attention kernel: inputs on different "
                         "devices")
    if q.dtype not in _TC_ROUTE or k.dtype != q.dtype or v.dtype != q.dtype:
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


def route(q, k, v) -> str | None:
    """The route that takes these inputs, on any view with ``dh``
    contiguous: ``"wgmma"`` for bfloat16, ``"split_f32"`` for float32, each
    at a head dim up to 256 (:data:`TILES`); None for inputs neither
    takes."""
    name = _TC_ROUTE.get(q.dtype)
    if name is not None and 0 < q.shape[3] <= TILES[name][-1]:
        return name
    return None


def tensor_core_route(q, k, v) -> bool:
    """Whether these inputs run on the tensor cores (a route takes them:
    every input the kernel takes)."""
    return route(q, k, v) is not None


def packed(q, k, v) -> tuple[bool, bool, bool]:
    """Which of q, k, v the ``"wgmma"`` route copies with :func:`pack_bf16`
    before the attention launch: those no TMA tensor map takes."""
    return tuple(not _tma_view(t) for t in (q, k, v))


def route_counter(name: str) -> _build.LaunchCount:
    """The counter that a launch on route ``name`` raises besides
    ``flash_attention_launches``."""
    return _COUNTER[name]


def tile_width(name: str, dh: int) -> int:
    """The padded head dim (DHP) of route ``name``'s instantiation that
    takes head dim ``dh``: the narrowest of ``TILES[name]`` at least
    ``dh``."""
    for w in TILES[name]:
        if 0 < dh <= w:
            return w
    raise ValueError(f"flash_attention kernel: head dim {dh} not in (0, "
                     f"{TILES[name][-1]}] of the {name} route")


def tensor_core_resources(dh: int, dtype=torch.bfloat16,
                          softcap: bool = False) -> dict:
    """Registers and local (spill) bytes a thread, dynamic shared bytes,
    threads a block and blocks resident an SM of the tensor-core
    instantiation that takes head dim ``dh`` in ``dtype`` (bfloat16: the
    wgmma route; float32: the split route), cap-free or soft-capped, as
    the CUDA runtime reports them for the current card."""
    name = _TC_ROUTE[dtype]
    dhp = tile_width(name, dh)
    fn = _build.bind(_LIB[bool(softcap)], "flash_attention_wgmma_resources",
                     [_build.I32, _build.I32, ctypes.POINTER(ctypes.c_int)])
    out = (ctypes.c_int * 5)()
    _build.check(fn(dhp, int(name == "split_f32"), out),
                 "flash_attention_wgmma_resources")
    return dict(zip(("registers", "local_bytes", "shared_bytes", "threads",
                     "blocks_per_sm"), out))


def _parts(x: torch.Tensor, dtype, parts: int, entry: str,
           count: _build.LaunchCount) -> torch.Tensor:
    """x [B,H,S,dh] in ``dtype`` on the card (``dh`` contiguous, any other
    strides) -> ``[parts,B,H,S,dh]`` bfloat16 from C entry ``entry``: a view
    of a contiguous ``[parts,B,H,S,dhp]`` buffer, ``dhp`` = ``dh`` rounded
    up to 8, so that every row starts on a 16-byte boundary (the columns
    past ``dh`` are 0)."""
    name = entry.removesuffix("_launch")
    if not x.is_cuda or x.dtype != dtype or x.dim() != 4:
        raise ValueError(f"{name}: want a 4-D {dtype} CUDA tensor, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if x.stride(3) != 1:
        raise ValueError(f"{name}: the last dim must be contiguous")
    B, H, S, dh = x.shape
    dhp = -(-dh // 8) * 8
    out = torch.empty((parts, B, H, S, dhp), dtype=torch.bfloat16,
                      device=x.device)
    fn = _build.bind("flash_attention", entry, _SPLIT_ARGS)
    code = _build.launch(fn, x.get_device(), x.data_ptr(), out.data_ptr(),
                         B, H, S, dh, dhp, *x.stride()[:3])
    _build.check(code, entry)
    count.n += 1
    return out[..., :dh]


def split_bf16x3(x: torch.Tensor) -> torch.Tensor:
    """x [B,H,S,dh] float32 on the card (``dh`` contiguous, any other
    strides) -> its three bfloat16 parts ``[3,B,H,S,dh]``: hi = bf16(x),
    mid = bf16(x - hi), lo = bf16(x - hi - mid). A view of a contiguous
    ``[3,B,H,S,dhp]`` buffer, ``dhp`` = ``dh`` rounded up to 8, so that
    every row starts on a 16-byte boundary (the columns past ``dh`` are
    0). Plain version: ``ref.split_bf16x3_ref``."""
    return _parts(x, torch.float32, 3, "split_bf16x3_launch",
                  split_bf16x3_launches)


def pack_bf16(x: torch.Tensor) -> torch.Tensor:
    """x [B,H,S,dh] bfloat16 on the card (``dh`` contiguous, any other
    strides) -> the same values as a view of a contiguous ``[B,H,S,dhp]``
    buffer, ``dhp`` = ``dh`` rounded up to 8 (the columns past ``dh`` are
    0), which a TMA tensor map takes. The same kernel as
    :func:`split_bf16x3`, on one part. Plain version:
    ``ref.pack_bf16_ref``."""
    return _parts(x, torch.bfloat16, 1, "pack_bf16_launch",
                  pack_bf16_launches)[0]


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, sm_scale: float | None = None,
                        softcap: float = 0.0) -> torch.Tensor:
    """q [B,Hq,Sq,dh], k/v [B,Hkv,Sk,dh] (any strides with ``dh``
    contiguous) -> o [B,Hq,Sq,dh] laid out as q. ``sm_scale`` defaults to
    ``1 / sqrt(dh)``; ``softcap`` > 0 soft-caps the scaled scores, 0 leaves
    them as they are."""
    _check(q, k, v)
    softcap = float(softcap)
    if not (softcap == 0.0 or 0.0 < softcap < float("inf")):
        raise ValueError(f"flash_attention kernel: softcap {softcap} is "
                         "neither 0 (off) nor a finite cap > 0")
    B, Hq, Sq, dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)           # q's strides, dh contiguous as in q
    scale = float(sm_scale or 1.0 / dh ** 0.5)
    which = route(q, k, v)
    if which == "split_f32":           # the parts as batches p * B + b
        q, k, v = (split_bf16x3(t).flatten(0, 1) for t in (q, k, v))
    else:                              # the operands no tensor map takes
        q, k, v = (pack_bf16(t) if p else t
                   for t, p in zip((q, k, v), packed(q, k, v)))
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    name = _ENTRY[which]
    fn = _build.bind(_LIB[softcap > 0], name, _ARGS)
    code = _build.launch(fn, o.get_device(), q.data_ptr(), k.data_ptr(),
                         v.data_ptr(), o.data_ptr(), B, Hq, Hkv, Sq, Sk, dh,
                         int(bool(causal)), *strides, int(window),
                         int(q_offset), scale, softcap,
                         tile_width(which, dh))
    _build.check(code, name)
    flash_attention_launches.n += 1
    route_counter(which).n += 1
    if softcap > 0:
        flash_attention_softcap_launches.n += 1
    return o
