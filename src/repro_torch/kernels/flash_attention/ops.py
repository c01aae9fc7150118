"""GQA prefill attention in the model layout ``[B, S, H, dh]``: the CUDA
flash kernel for CUDA tensors, the plain version for CPU tensors (or when
the caller opts out).

Counterpart of ``src/repro/kernels/flash_attention/ops.py``. The kernel
reads the model layout in place through strides, so neither a transpose
copy nor the reference's padding of ``dh`` to 128 and of the sequence to
the block size is needed.
"""

from __future__ import annotations

import torch

from .kernel import flash_attention_fwd
from .ref import flash_attention_ref


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, softcap: float = 0.0,
                    use_kernel: bool = True) -> torch.Tensor:
    """q [B,Sq,Hq,dh], k/v [B,Sk,Hkv,dh] -> [B,Sq,Hq,dh] in q's dtype;
    ``softcap`` > 0 soft-caps the scaled scores before the mask."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention is forward-only: an input requires grad under "
            "grad mode, and the output would be cut from the autograd "
            "graph; train through repro_torch.models.attention."
            "train_attention (Transformer.train_forward)")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if use_kernel and q.is_cuda:
        o = flash_attention_fwd(qt, kt, vt, causal=causal, window=window,
                                q_offset=q_offset, softcap=softcap)
    else:
        o = flash_attention_ref(qt, kt, vt, causal=causal, window=window,
                                q_offset=q_offset, softcap=softcap)
    return o.transpose(1, 2)
