"""State carried across from the JAX package, as numpy arrays.

The reference hands its state over as numpy (``np.asarray`` of every
leaf); this module turns such trees into the port's tensors and back. bf16
arrives as ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` does not
take: it crosses through an ``int16`` view. Arrays that are not writable
are copied first. Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def array_from_numpy(a, device=None) -> torch.Tensor:
    dev = resolve_device(device)
    a = np.asarray(a)
    if not a.flags.writeable or not a.flags.c_contiguous:
        a = np.ascontiguousarray(a).copy()
    if _is_bf16(a):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def array_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def tree_from_numpy(tree, device=None):
    """Nested dicts / lists of numpy arrays -> the same tree of tensors."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_from_numpy(v, device) for v in tree)
    return array_from_numpy(tree, device)


def tree_to_numpy(tree):
    """Inverse of :func:`tree_from_numpy`."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_numpy(v) for v in tree)
    return array_to_numpy(tree)


_TIERED_KEYS = ("leap", "pool_meta", "ring", "hot")


def tiered_state_from_numpy(state_np: dict, device=None) -> dict:
    """A reference tiered state (``tiered_init`` / ``tiered_sweep`` output,
    leaves numpy with the leading stream axis) as the port's state dict."""
    missing = [k for k in _TIERED_KEYS if k not in state_np]
    if missing:
        raise ValueError(f"tiered state lacks {missing}")
    return {k: tree_from_numpy(state_np[k], device) for k in _TIERED_KEYS}
