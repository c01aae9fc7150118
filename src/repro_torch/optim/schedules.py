"""LR schedules as step -> lr callables.

Counterpart of ``repro.optim.schedules``, in the same float32 arithmetic:
``step`` (a host int) becomes a float32 0-dim tensor on the CPU, and every
Python constant combines with it as a float32 scalar, as a Python float
combines with a float32 array in JAX. The cosine is taken in float64 and
rounded to float32: the CPU's float32 ``cos`` can be an ulp off the
correctly rounded value that XLA's returns.
"""

from __future__ import annotations

import math

import torch


def linear_warmup(peak: float, warmup_steps: int):
    def lr(step: int) -> torch.Tensor:
        s = torch.tensor(step, dtype=torch.float32)
        return peak * torch.clamp((s + 1) / max(1, warmup_steps), max=1.0)
    return lr


def cosine_warmup(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1):
    def lr(step: int) -> torch.Tensor:
        s = torch.tensor(step, dtype=torch.float32)
        warm = (s + 1) / max(1, warmup_steps)
        frac = torch.clamp((s - warmup_steps)
                           / max(1, total_steps - warmup_steps), 0.0, 1.0)
        c = torch.cos((math.pi * frac).double()).float()
        cos = floor + (1 - floor) * 0.5 * (1 + c)
        return peak * torch.minimum(warm, cos)
    return lr
