"""Int8 codecs: the error-feedback gradient codec and the stateless page
codec of the compressed cold tier (DESIGN.md §12.3).

Counterpart of ``repro.runtime.compression``. Both quantize to int8 with a
float32 scale ``max|x| / 127 + 1e-12``.

**Gradient path** (:func:`compress_int8`, :func:`compressed_psum`): the
gradient plus the carried error is quantized with one scale a leaf, and
the residual is carried into the next step (error feedback).
:func:`compressed_psum` sums the int8 payloads as int32 with an
``all_reduce`` over a ``torch.distributed`` group and averages the scales
(a SUM divided by the world size, which is ``pmean``: gloo has no AVG),
then returns the mean gradient and the new errors.

**Page codec**: one int8
payload and one float32 scale a page, no error feedback (pages are read
back many times and out of order, so the codec is a pure function of the
page's bytes). ``scale = max|page| / 127 + 1e-12``; every element
reconstructs within ``scale / 2``. Demotion applies :func:`page_roundtrip`
to a page's cold bytes once, so every later reader sees the same
post-roundtrip bytes. The round trip is not idempotent on every page (the
page ``[2^-9]`` moves by 2.3e-10 on a second trip), as in the reference.

The division by 127 is by a tensor, never by a Python number: on a CUDA
tensor PyTorch turns division by a host scalar into a multiply by its
reciprocal, which rounds the scale one ulp off on some pages. Divided by a
tensor, the card computes the same IEEE quotients as the CPU, and both
equal the reference's eager ``page_roundtrip`` bit for bit; so do
``q``, the scale and the new error of :func:`compress_int8`, whose
``round(x / scale)`` divides by the scale, a tensor.
"""

from __future__ import annotations

import torch

from repro_torch.checkpoint.checkpoint import flatten, map_tree


def _scale(pf: torch.Tensor, dims) -> torch.Tensor:
    """``max|pf| / 127 + 1e-12`` in float32, reduced over ``dims`` (all
    dims for ``()``), kept broadcastable against ``pf``."""
    a = pf.abs()
    amax = a.amax(dim=dims, keepdim=True) if dims else a.max()
    return amax / torch.full_like(amax, 127.0) + 1e-12


def _quantize(pf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.round(pf / scale).clamp(-127, 127).to(torch.int8)


def compress_page(page: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One page (any shape, float or integer dtype) to ``(q int8 [same
    shape], scale float32 0-dim)``."""
    pf = page.float()
    scale = _scale(pf, ())
    return _quantize(pf, scale), scale


def decompress_page(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`compress_page` up to the ``scale / 2`` bound."""
    return (q.float() * scale).to(dtype)


def page_roundtrip(page: torch.Tensor) -> torch.Tensor:
    """Compress and decompress one page (same shape and dtype)."""
    q, scale = compress_page(page)
    return decompress_page(q, scale, dtype=page.dtype)


def roundtrip_pages(pages: torch.Tensor) -> torch.Tensor:
    """:func:`page_roundtrip` of each ``pages[i]`` (one scale a page), in
    one pass; equal, page for page, to the one-page form."""
    pf = pages.reshape(pages.shape[0], -1).float()
    scale = _scale(pf, (1,))
    out = _quantize(pf, scale).float() * scale
    return out.to(pages.dtype).reshape(pages.shape)


# ---- error-feedback gradient codec -----------------------------------------
def init_error_feedback(grads_like):
    """Zeroed float32 errors of the shapes of ``grads_like``'s leaves
    (nested dicts / lists of tensors)."""
    return map_tree(grads_like, lambda _, g: torch.zeros(
        g.shape, dtype=torch.float32, device=g.device))


def compress_int8(g: torch.Tensor, err: torch.Tensor):
    """``(q int8, scale float32 0-dim, new_err float32)``: ``q * scale +
    new_err`` is ``g + err``."""
    gf = g.float() + err
    scale = _scale(gf, ())
    q = _quantize(gf, scale)
    return q, scale, gf - q.float() * scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(grads, err_state, group=None):
    """Quantize, ``all_reduce`` SUM the payloads as int32 (no overflow for
    up to 2^23 ranks), average the scales, dequantize; with error
    feedback. ``grads`` and ``err_state`` are trees (nested dicts / lists)
    of one structure; ``group`` a ``torch.distributed`` process group (the
    default one for ``None``). Returns ``(mean grads, new err_state)``."""
    import torch.distributed as dist

    n = dist.get_world_size(group)

    def one(g, e):
        q, scale, new_e = compress_int8(g, e)
        tot = q.to(torch.int32)
        dist.all_reduce(tot, op=dist.ReduceOp.SUM, group=group)
        ssum = scale.reshape(1).clone()
        dist.all_reduce(ssum, op=dist.ReduceOp.SUM, group=group)
        nt = torch.full((), float(n), dtype=torch.float32, device=g.device)
        return (tot.float() * (ssum[0] / nt) / nt).to(g.dtype), new_e

    errs = dict(flatten(err_state))
    outs = {name: one(g, errs[name]) for name, g in flatten(grads)}
    return (map_tree(grads, lambda name, _: outs[name][0]),
            map_tree(grads, lambda name, _: outs[name][1]))
