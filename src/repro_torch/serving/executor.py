"""Model executors: per-request token production for the serving engine.

Counterpart of ``repro.serving.executor``. Two implementations:

* :class:`ModelExecutor` — the real model. Each request owns a batch-1
  decode state; chunked prefill feeds prompt tokens one by one through the
  same ``decode_step`` the decode path uses, and the chunk that consumes
  the last prompt token emits the first output token (greedy argmax). The
  K/V it hands the engine to mirror into the paged pool are the K/V (roped
  where the model uses RoPE) of the first attention layer at the input
  token's position; a model with no attention layer (xLSTM) mirrors the
  synthetic executor's K/V instead, so the data path still runs end to
  end. As the reference's, it refuses the encoder-decoder family (the
  batch driver serves it) and a request longer than a sliding window (the
  rolling buffer would overwrite positions the mirror holds).
* :class:`SyntheticExecutor` — no model: hashed K/V keyed by
  ``(seed, request, position)`` and counter tokens.

The synthetic executor's K/V bytes
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
from repro_torch.models.model import build_model

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


class ModelExecutor:
    """Real model, batch-1 per-request decode states, chunked prefill.

    ``model``: a built :class:`~repro_torch.models.transformer.Transformer`
    of ``cfg`` (for example converted from the reference's parameters);
    by default one is built on ``device`` with parameters from ``seed``.
    Prompt tokens come from a CPU ``torch.Generator`` keyed by
    ``(seed + 1, req_id)``; the reference draws them with ``jax.random``,
    so ``prompts`` (``{req_id: int sequence}``) may hand them over instead.

    ``n_q_heads`` is the model's query-head count, so the engine's per-step
    pin draws queries of the model's GQA shape (the reference's executor
    leaves it unset, and its engine then draws ``Hkv`` heads).
    """

    def __init__(self, cfg, seed: int = 0, device=None, model=None,
                 prompts: dict | None = None):
        if cfg.family == "encdec":
            raise ValueError("continuous-batching engine drives decoder-only "
                             "families; encdec serving stays on the batch "
                             "driver")
        self.cfg = cfg
        if model is None:
            model = build_model(cfg, device=device, seed=seed)
        elif model.dtype != getattr(torch, str(cfg.dtype)):
            raise ValueError(f"model dtype {model.dtype} is not the "
                             f"config's {cfg.dtype}")
        self.model = model
        self.device = model.device
        self.seed = seed
        self._given = {int(k): v for k, v in (prompts or {}).items()}
        self._states: dict[int, dict] = {}
        self._prompts: dict[int, torch.Tensor] = {}
        self._last_tok: dict[int, torch.Tensor] = {}
        self.last_logits: dict[int, torch.Tensor] = {}
        kinds = [k["mix"] for k in cfg.layer_kinds()]
        # the first attention layer's K/V are mirrored; a cache-free model
        # (no attention layer) mirrors synthetic K/V keyed by (request,
        # position), as the reference's (seed + 2)
        self.kv_layer = kinds.index("attn") if "attn" in kinds else None
        self._synth = (SyntheticExecutor(cfg.n_kv_heads, cfg.head_dim,
                                         model.dtype, seed=seed + 2,
                                         device=self.device)
                       if self.kv_layer is None else None)
        # a rolling sliding-window cache would overwrite mirrored
        # positions: a request must fit the window (checked in begin())
        self._cache_cap = cfg.sliding_window or None
        self.n_kv_heads = cfg.n_kv_heads
        self.n_q_heads = cfg.n_heads
        self.head_dim = cfg.head_dim
        self.dtype = str(model.dtype).removeprefix("torch.")

    def prompt_tokens(self, req: Request) -> torch.Tensor:
        """``int64 [prompt_len]`` on the model's device."""
        if req.req_id not in self._prompts:
            toks = self._given.get(req.req_id)
            if toks is None:
                g = torch.Generator().manual_seed(
                    (self.seed + 1) * 1_000_003 + req.req_id)
                toks = torch.randint(0, self.cfg.vocab_size,
                                     (req.prompt_len,), generator=g)
            toks = (toks.long() if torch.is_tensor(toks)
                    else torch.tensor(toks, dtype=torch.long))
            if toks.shape != (req.prompt_len,):
                raise ValueError(f"request {req.req_id}: prompt of shape "
                                 f"{tuple(toks.shape)}, expected "
                                 f"({req.prompt_len},)")
            self._prompts[req.req_id] = toks.to(self.device)
        return self._prompts[req.req_id]

    def begin(self, req: Request) -> None:
        if self._cache_cap is not None and req.max_len > self._cache_cap:
            raise ValueError(
                f"request {req.req_id}: max_len {req.max_len} exceeds the "
                f"sliding-window cache ({self._cache_cap}) — the paged "
                "mirror would lose overwritten positions")
        self.prompt_tokens(req)
        self._states[req.req_id] = self.model.init_decode_state(1,
                                                                req.max_len)

    def end(self, req: Request) -> None:
        self._states.pop(req.req_id, None)
        self._prompts.pop(req.req_id, None)
        self._last_tok.pop(req.req_id, None)
        self.last_logits.pop(req.req_id, None)

    def _feed(self, req: Request, token: torch.Tensor):
        """One ``decode_step`` on ``token [1]``: ``(logits [V], k, v)``,
        k/v ``[Hkv, dh]`` the first attention layer's K/V written for the
        input token at its position (views of the cache), or the
        synthetic K/V of that position for a cache-free model."""
        state = self._states[req.req_id]
        pos = state["pos"]
        logits, state = self.model.decode_step(token, state)
        if self.kv_layer is None:
            k, v = self._synth._kv(req, pos, 1)
            return logits[0], k[0], v[0]
        blk = state["blocks"][self.kv_layer]
        return logits[0], blk["k"][0, pos], blk["v"][0, pos]

    def _emit(self, req: Request, logits: torch.Tensor) -> int:
        tok = torch.argmax(logits)
        self._last_tok[req.req_id] = tok.reshape(1)
        self.last_logits[req.req_id] = logits
        return int(tok)

    def prefill_chunk(self, req: Request, n: int):
        """Consume ``n`` prompt tokens; K/V ``[n, Hkv, dh]``; the first
        output token when the prompt is exhausted."""
        prompt = self.prompt_tokens(req)
        ks, vs = [], []
        logits = None
        for j in range(req.prefilled, req.prefilled + n):
            logits, k, v = self._feed(req, prompt[j:j + 1])
            ks.append(k)
            vs.append(v)
        tok = None
        if req.prefilled + n >= req.prompt_len:
            tok = self._emit(req, logits)
        return torch.stack(ks), torch.stack(vs), tok

    def decode(self, req: Request):
        """Consume the last emitted token, emit the next one."""
        logits, k, v = self._feed(req, self._last_tok[req.req_id])
        return k.clone(), v.clone(), self._emit(req, logits)

    def oneshot_prefill_logits(self, req: Request) -> torch.Tensor:
        """Reference: ``prefill`` over the same prompt in one shot (the
        chunked-prefill equivalence oracle; ``[V]`` float32)."""
        logits, _ = self.model.prefill(self.prompt_tokens(req)[None],
                                       req.max_len)
        return logits[0]
