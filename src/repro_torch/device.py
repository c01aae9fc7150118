"""Device resolution: CUDA by default, the CPU only when asked for.

The port never moves to the CPU by itself. An entry point called without a
device runs on ``cuda``; when no GPU is present that raises instead of
silently running the plain PyTorch versions on the host.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a GPU raises."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: "
            "--device cpu) to run the plain PyTorch versions on the host")
    return dev


_ARANGE: dict = {}


def cached_arange(n: int, device, start: int = 0) -> torch.Tensor:
    """``arange(start, start + n)`` as int32 on ``device``, built once.

    The control plane's per-access loops use small index ranges thousands
    of times per sweep; building each once keeps them from costing a
    launch (or a host-to-device copy) every time. Callers must not write
    into the result.
    """
    key = (n, start, torch.device(device))
    ar = _ARANGE.get(key)
    if ar is None:
        ar = _ARANGE[key] = torch.arange(start, start + n, dtype=torch.int32,
                                         device=device)
    return ar
