"""The stateless int8 page codec of the compressed cold tier (DESIGN.md §12.3).

Counterpart of the page codec in ``repro.runtime.compression``: one int8
payload and one float32 scale a page, no error feedback (pages are read
back many times and out of order, so the codec is a pure function of the
page's bytes). ``scale = max|page| / 127 + 1e-12``; every element
reconstructs within ``scale / 2``. Demotion applies :func:`page_roundtrip`
to a page's cold bytes once, so every later reader sees the same
post-roundtrip bytes. The round trip is not idempotent on every page (the
page ``[2^-9]`` moves by 2.3e-10 on a second trip), as in the reference.
(The reference's error-feedback gradient codec belongs to the training
side, ROADMAP queue 1 item 4.)

The division by 127 is by a tensor, never by a Python number: on a CUDA
tensor PyTorch turns division by a host scalar into a multiply by its
reciprocal, which rounds the scale one ulp off on some pages. Divided by a
tensor, the card computes the same IEEE quotients as the CPU, and both
equal the reference's eager ``page_roundtrip`` bit for bit.
"""

from __future__ import annotations

import torch


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
