"""Synthetic executor: the serving data path without a model.

Counterpart of ``repro.serving.executor.SyntheticExecutor``. Its K/V bytes
depend only on ``(seed, req_id, position)``, so they do not change with
the prefill chunking or the slot a request lands in. PyTorch has no
``fold_in``; the bytes come from a counter-based hash written in torch
integer ops (32-bit values held in int64, so no product overflows), turned
into normals by Box–Muller, vectorised over the positions of a chunk. The
values differ from the reference's ``jax.random`` bytes; what carries over
is that they are a fixed function of the key.
"""

from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device

from .request import Request

_M32 = 0xFFFFFFFF


def _mix(x: torch.Tensor) -> torch.Tensor:
    """32-bit integer finaliser over int64 tensors holding values < 2^32
    (multipliers < 2^31 keep every product below 2^63)."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x4C8F2E3B) & _M32
    x = x ^ (x >> 16)
    return x


def synth_kv(seed: int, req_id: int, start: int, n: int, hkv: int, dh: int,
             dtype: torch.dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Deterministic K/V ``[n, Hkv, dh]`` for positions ``start..start+n-1``."""
    dev = torch.device(device)
    key = _mix(torch.tensor([seed * 0x9E3779B + 0x632BE5AB], dtype=torch.int64,
                            device=dev))
    key = _mix(key ^ (req_id & _M32))
    pos = torch.arange(start, start + n, dtype=torch.int64, device=dev)
    kp = _mix(key ^ pos)[:, None]                          # [n, 1]
    e = torch.arange(2 * 2 * hkv * dh, dtype=torch.int64, device=dev)[None]
    bits = _mix(_mix(kp + e * 0x61C88647) ^ (kp >> 7))     # [n, 2*E2]
    u = bits.to(torch.float64) / 2.0 ** 32
    u1, u2 = 1.0 - u[:, 0::2], u[:, 1::2]                  # u1 in (0, 1]
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
    kv = z.to(torch.float32).reshape(n, 2, hkv, dh).to(dtype)
    return kv[:, 0], kv[:, 1]


class SyntheticExecutor:
    """Hashed K/V + counter tokens; the data path without the model.

    ``n_q_heads`` (default ``n_kv_heads``) sets the query heads the engine
    draws per step; ``dtype`` the K/V and query type.
    """

    def __init__(self, n_kv_heads: int, head_dim: int, dtype="float32",
                 seed: int = 0, n_q_heads: int | None = None, device=None):
        self.n_kv_heads = n_kv_heads
        self.head_dim = head_dim
        self.n_q_heads = n_kv_heads if n_q_heads is None else n_q_heads
        self.torch_dtype = (dtype if isinstance(dtype, torch.dtype)
                            else getattr(torch, str(dtype)))
        self.dtype = str(self.torch_dtype).removeprefix("torch.")
        self.seed = seed
        self.device = resolve_device(device)

    def begin(self, req: Request) -> None:
        pass

    def end(self, req: Request) -> None:
        pass

    def _kv(self, req: Request, start: int, n: int):
        return synth_kv(self.seed, req.req_id, start, n, self.n_kv_heads,
                        self.head_dim, self.torch_dtype, self.device)

    def prefill_chunk(self, req: Request, n: int):
        """K/V for prompt positions ``[prefilled, prefilled+n)`` and, when
        the chunk finishes the prompt, the first output token."""
        k, v = self._kv(req, req.prefilled, n)
        done = req.prefilled + n >= req.prompt_len
        tok = req.req_id % 251 if done else None
        return k, v, tok

    def decode(self, req: Request):
        """K/V of the token being consumed (position ``length - 1``) and the
        next output token."""
        pos = req.prefilled + req.decoded - 1
        k, v = self._kv(req, pos, 1)
        return k[0], v[0], (req.req_id + req.decoded) % 251
