"""Decoder-only LM, dense, MoE, hybrid and xLSTM families: one block
module per layer.

Counterpart of ``repro.models.transformer``. The reference stacks the
parameters of each position of the layer pattern ``[n_periods, ...]`` and
scans over periods; eager PyTorch has no use for that, so here every layer
is its own :class:`Block` and the trunk is a Python loop.
``repro_torch.convert.model_params_from_jax`` unstacks the reference's
parameters into this layout.

Entry points, as the reference's: :meth:`Transformer.init_params`,
:meth:`~Transformer.embed_tokens`, :meth:`~Transformer.lm_head`,
:meth:`~Transformer.init_decode_state`, :meth:`~Transformer.decode_step`
(one token + state -> logits + state), :meth:`~Transformer.prefill`
(tokens -> last logits + decode state) and
:meth:`~Transformer.train_forward` (a batch -> the training loss, through
autograd). The decode state is
``{"blocks": [one dict per layer], "pos": int}``: an attention layer holds
its caches ``{"k", "v"}`` ``[B, T, Hkv, dh]``, a Mamba layer its carry
``{"conv" [B, K-1, di], "h" [B, di, N] float32}``, an mLSTM layer
``{"conv", "C", "n", "m"}`` and an sLSTM layer ``{"h", "c", "n", "m"}``
(:mod:`.xlstm`). ``decode_step`` updates the per-layer dicts **in place**
(K/V written into the caches) and advances ``pos`` (the reference returns
a new state), which saves a cache copy per token. ``pos`` is a host int,
so no step waits on the device to learn it.

What is built: every family but the encoder-decoder (:mod:`.encdec`).
Attention layers with a SwiGLU or GeGLU MLP or a MoE (``layer_kinds()``
interleaves them by ``moe_every`` / ``moe_offset``, with the shared expert
of ``n_shared_experts``), Mamba layers (jamba), mLSTM / sLSTM layers with
no feed-forward (xLSTM, ``ff: "none"``); RMSNorm or LayerNorm; RoPE,
M-RoPE (qwen2-vl: ``prefill`` takes ``positions3 [3, B, S]`` and
``embeds [B, S, D]``) or none. A sliding window keeps the reference's
rolling buffer of ``T = min(max_len, window)`` slots: token ``j`` lives at
slot ``j % T``, prefill attention is masked to the window, and decode
attends the whole buffer (it holds the window). Prefill attention goes
through the flash-attention kernel on the card; Mamba prefill through the
selective-scan kernel. Both kernels are forward-only, so ``train_forward``
takes the reference's differentiated routes instead,
``attention.train_attention``, ``mamba.apply_mamba_train``,
``xlstm.apply_mlstm_train`` and ``xlstm.apply_slstm_train``, and routes
its MoE layers with capacity drops (``dropless=False``), adding their
Switch aux loss as the reference's ``_block_apply`` does; each block runs
under ``torch.utils.checkpoint`` when ``cfg.remat`` is set (the reference
checkpoints each scan period). The trunk calls the sharding hooks of
:mod:`repro_torch.distributed.activations` at the reference's sites (the
normed input of each block's products, q / k / v, the residual stream at
each period boundary) and on each branch output before the residual
add; they are the identity unless the sharded train step installs
them. :func:`param_specs` gives each parameter the
reference's logical axes, without its leading ``"layers"``. Parameters
are built with ``requires_grad=False``; a model for training turns it on
(``build_model(..., trainable=True)``). Attention logit soft-capping
(``cfg.attn_logit_softcap`` > 0) reaches every attention route, as the
reference's: the flash kernel at prefill (its capped instantiations),
``decode_attention`` and ``train_attention``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed.activations import (activation_constraint,
                                                 attn_constraint,
                                                 decode_state_constraint,
                                                 grad_as_forward,
                                                 matmul_input_constraint,
                                                 replicate, split_evenly)

from .attention import blocked_attention, decode_attention, train_attention
from .config import ModelConfig
from .layers import (apply_mlp, apply_norm, apply_rotary, chunked_ce_loss,
                     dense_init_, embed_init_, mrope_angles, norm_init_,
                     rope_angles)
from .mamba import (MAMBA_SPECS, apply_mamba, apply_mamba_train,
                    mamba_decode_step, mamba_init_, mamba_shapes,
                    mamba_state_init)
from .mamba import F32_LEAVES as MAMBA_F32
from .moe import apply_moe
from .xlstm import F32_LEAVES as XLSTM_F32
from .xlstm import (MLSTM_SPECS, SLSTM_SPECS, apply_mlstm,
                    apply_mlstm_train, apply_slstm, apply_slstm_train,
                    mlstm_decode_step, mlstm_init_, mlstm_shapes,
                    mlstm_state_init, slstm_decode_step, slstm_init_,
                    slstm_shapes, slstm_state_init)


def _param(shape, dtype, device) -> nn.Parameter:
    """A parameter of the serving paths: no grad until a trainer asks
    (``build_model(..., trainable=True)``)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def _dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


#: each mixer's decode-state leaves -> their logical axes (the
#: reference's ``decode_state_specs`` without the leading ``"layers"``)
STATE_SPECS = {
    "attn": {"k": ("batch", "kv_seq", "kv_heads_s", None),
             "v": ("batch", "kv_seq", "kv_heads_s", None)},
    "mamba": {"conv": ("batch", None, "inner"), "h": ("batch", "inner", None)},
    "mlstm": {"conv": ("batch", None, "inner"),
              "C": ("batch", None, None, None), "n": ("batch", None, None),
              "m": ("batch", None)},
    "slstm": {k: ("batch", "embed") for k in ("h", "c", "n", "m")},
}


def param_specs(model: nn.Module) -> dict:
    """Parameter name -> the reference's logical axes of that leaf,
    without the leading ``"layers"`` of a stacked one, in
    ``named_parameters`` order: each module that holds parameters names
    their axes in its ``SPECS``."""
    owner = {}
    for mname, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            owner[f"{mname}.{pname}" if mname else pname] = \
                mod.SPECS[pname]
    return {name: owner[name] for name, _ in model.named_parameters()}


def cache_len(cfg: ModelConfig, max_len: int) -> int:
    """Slots of an attention layer's cache: ``max_len``, or the rolling
    buffer's ``min(max_len, window)`` under a sliding window."""
    return min(max_len, cfg.sliding_window) if cfg.sliding_window \
        else max_len


class Norm(nn.Module):
    """RMSNorm with a ``scale [d]``, or LayerNorm with a ``bias [d]`` as
    well (``cfg.norm``)."""

    SPECS = {"scale": ("embed",), "bias": ("embed",)}

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.eps = cfg.norm_eps
        self.scale = _param((cfg.d_model,), dtype, device)
        self.bias = (_param((cfg.d_model,), dtype, device)
                     if cfg.norm == "layernorm" else None)

    def init_params(self) -> None:
        norm_init_(self.scale, self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_norm(self.scale, x, self.eps, self.bias)


class Attention(nn.Module):
    """``wq [d, Hq*dh]``, ``wk``/``wv [d, Hkv*dh]``, ``wo [Hq*dh, d]``
    (``[d_in, d_out]``), with the QKV biases when the config has them."""

    SPECS = {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
             "wv": ("embed", "kv_heads"), "wo": ("heads", "embed"),
             "bq": ("heads",), "bk": ("kv_heads",), "bv": ("kv_heads",)}

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, h = cfg.d_model, cfg.head_dim
        self.n_heads, self.n_kv_heads, self.head_dim = (cfg.n_heads,
                                                        cfg.n_kv_heads, h)
        self.wq = _param((d, cfg.n_heads * h), dtype, device)
        self.wk = _param((d, cfg.n_kv_heads * h), dtype, device)
        self.wv = _param((d, cfg.n_kv_heads * h), dtype, device)
        self.wo = _param((cfg.n_heads * h, d), dtype, device)
        if cfg.qkv_bias:
            self.bq = _param((cfg.n_heads * h,), dtype, device)
            self.bk = _param((cfg.n_kv_heads * h,), dtype, device)
            self.bv = _param((cfg.n_kv_heads * h,), dtype, device)
        else:
            self.bq = self.bk = self.bv = None

    def init_params(self, gen: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            dense_init_(w, gen)
        for b in (self.bq, self.bk, self.bv):
            if b is not None:
                with torch.no_grad():
                    b.zero_()

    def q(self, y: torch.Tensor) -> torch.Tensor:
        """y [B,S,d] -> q [B,S,Hq,dh], not roped."""
        q = y @ self.wq
        if self.bq is not None:
            q = q + self.bq
        q = split_evenly(q, 2, self.n_heads)
        return q.reshape(*y.shape[:2], self.n_heads, self.head_dim)

    def kv(self, y: torch.Tensor):
        """y [B,S,d] -> k, v [B,S,Hkv,dh], not roped."""
        k, v = y @ self.wk, y @ self.wv
        if self.bk is not None:
            k, v = k + self.bk, v + self.bv
        sh = (*y.shape[:2], self.n_kv_heads, self.head_dim)
        k, v = (split_evenly(t, 2, self.n_kv_heads) for t in (k, v))
        return k.reshape(sh), v.reshape(sh)

    def qkv(self, y: torch.Tensor, angles: torch.Tensor | None):
        """y [B,S,d] -> q [B,S,Hq,dh], k/v [B,S,Hkv,dh]; q and k roped
        unless ``angles`` is ``None`` (``rope_type="none"``). ``angles``
        is ``[S, dh/2]`` or, per row (M-RoPE), ``[B, S, dh/2]``."""
        q, (k, v) = self.q(y), self.kv(y)
        if angles is None:
            return q, k, v
        a = (angles[None] if angles.dim() == 2 else angles)[:, :, None, :]
        return apply_rotary(q, a), apply_rotary(k, a), v


class MLP(nn.Module):
    """SwiGLU (or GeGLU with ``cfg.act="gelu"``): ``wg``/``wu [d, ff]``,
    ``wd [ff, d]``; ``ff`` is ``cfg.d_ff`` unless given (a MoE's shared
    expert)."""

    SPECS = {"wg": ("embed", "ff"), "wu": ("embed", "ff"),
             "wd": ("ff", "embed")}

    def __init__(self, cfg: ModelConfig, dtype, device,
                 ff: int | None = None):
        super().__init__()
        ff = cfg.d_ff if ff is None else ff
        self.act = cfg.act
        self.wg = _param((cfg.d_model, ff), dtype, device)
        self.wu = _param((cfg.d_model, ff), dtype, device)
        self.wd = _param((ff, cfg.d_model), dtype, device)

    def init_params(self, gen: torch.Generator) -> None:
        for w in (self.wg, self.wu, self.wd):
            dense_init_(w, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_mlp(self.wg, self.wu, self.wd, x, self.act)


class Leaves(nn.Module):
    """A mixer held as named leaves (:mod:`.mamba`, :mod:`.xlstm`), in the
    model dtype but ``f32`` (those kept float32); ``p()`` hands them to the
    module's functions as a mapping, ``init_params`` fills them with
    ``init_``; ``specs`` are their logical axes."""

    def __init__(self, shapes: dict, f32: tuple, init_, specs: dict, dtype,
                 device, **attrs):
        super().__init__()
        self.names = tuple(shapes)
        self._init = init_
        self.SPECS = specs
        for name, sh in shapes.items():
            setattr(self, name, _param(
                sh, torch.float32 if name in f32 else dtype, device))
        for k, v in attrs.items():
            setattr(self, k, v)

    def p(self) -> dict:
        return {n: getattr(self, n) for n in self.names}

    def init_params(self, gen: torch.Generator) -> None:
        self._init(self.p(), gen)


def mixer(cfg: ModelConfig, mix: str, dtype, device) -> nn.Module:
    """The mixer of a layer of kind ``mix``."""
    d = cfg.d_model
    if mix == "attn":
        return Attention(cfg, dtype, device)
    if mix == "mamba":
        return Leaves(mamba_shapes(d, cfg.mamba_expand, cfg.mamba_d_state,
                                   cfg.mamba_d_conv), MAMBA_F32, mamba_init_,
                      MAMBA_SPECS, dtype, device, d_state=cfg.mamba_d_state)
    if mix == "mlstm":
        return Leaves(mlstm_shapes(d, cfg.n_heads, cfg.xlstm_proj_factor,
                                   cfg.xlstm_conv), XLSTM_F32, mlstm_init_,
                      MLSTM_SPECS, dtype, device)
    if mix == "slstm":
        return Leaves(slstm_shapes(d, cfg.n_heads), XLSTM_F32, slstm_init_,
                      SLSTM_SPECS, dtype, device)
    raise ValueError(f"unknown mixer {mix!r}")


class MoE(nn.Module):
    """Router ``wr [d, E]`` and experts ``wg`` / ``wu [E, d, F]``,
    ``wd [E, F, d]`` (:mod:`.moe`); with ``n_shared_experts`` a ``shared``
    :class:`MLP` of width ``F * n_shared_experts``."""

    # EP x FSDP: experts over 'model', the expert ff dim over 'data'
    SPECS = {"wr": ("embed", "experts"),
             "wg": ("experts", None, "expert_ff"),
             "wu": ("experts", None, "expert_ff"),
             "wd": ("experts", "expert_ff", None)}

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, E, F = cfg.d_model, cfg.n_experts, cfg.ff_expert
        self.top_k, self.capacity_factor = cfg.top_k, cfg.capacity_factor
        self.act = cfg.act
        self.wr = _param((d, E), dtype, device)
        self.wg = _param((E, d, F), dtype, device)
        self.wu = _param((E, d, F), dtype, device)
        self.wd = _param((E, F, d), dtype, device)
        self.shared = (MLP(cfg, dtype, device, F * cfg.n_shared_experts)
                       if cfg.n_shared_experts else None)

    def init_params(self, gen: torch.Generator) -> None:
        dense_init_(self.wr, gen)
        for w in (self.wg, self.wu, self.wd):        # fan-in: dim 1
            dense_init_(w, gen, scale=w.shape[1] ** -0.5)
        if self.shared is not None:
            self.shared.init_params(gen)

    def p(self) -> dict:
        p = {"wr": self.wr, "wg": self.wg, "wu": self.wu, "wd": self.wd}
        if self.shared is not None:
            s = self.shared
            p["shared"] = {"wg": s.wg, "wu": s.wu, "wd": s.wd}
        return p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Inference routing: dropless, as the reference's prefill and
        decode."""
        return apply_moe(self.p(), x, self.top_k, self.capacity_factor,
                         self.act, dropless=True)[0]

    def forward_train(self, x: torch.Tensor):
        """Training routing: capacity drops, as the reference's
        ``train_forward``; ``(y, Switch aux loss)``."""
        return apply_moe(self.p(), x, self.top_k, self.capacity_factor,
                         self.act, dropless=False)


class Block(nn.Module):
    """One layer: ``norm1 -> mix (attention, Mamba, mLSTM or sLSTM) ->
    norm2 -> ff (MLP or MoE)``, each a residual branch (the reference's
    parameter tree names); ``ff: "none"`` has no ``norm2`` and no ``ff``."""

    def __init__(self, cfg: ModelConfig, kind: dict, dtype, device):
        super().__init__()
        self.kind = kind
        self.norm1 = Norm(cfg, dtype, device)
        self.mix = mixer(cfg, kind["mix"], dtype, device)
        self.norm2 = self.ff = None
        if kind["ff"] != "none":
            self.norm2 = Norm(cfg, dtype, device)
            self.ff = (MLP(cfg, dtype, device) if kind["ff"] == "mlp"
                       else MoE(cfg, dtype, device))

    def init_params(self, gen: torch.Generator) -> None:
        self.norm1.init_params()
        self.mix.init_params(gen)
        if self.ff is not None:
            self.norm2.init_params()
            self.ff.init_params(gen)

    def feed_forward(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.ff is None else x + self.ff(self.norm2(x))


class Transformer(nn.Module):
    """The decoder-only LM of ``cfg``, parameters in ``cfg.dtype`` on
    ``device`` (``None``: CUDA), left uninitialised until
    :meth:`init_params` or a conversion fills them."""

    SPECS = {"embed": ("vocab", "embed"), "lm_head_w": ("embed", "vocab")}

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        cfg.validate()
        if cfg.family == "encdec":
            raise ValueError(f"{cfg.name}: the encoder-decoder family is "
                             "built by repro_torch.models.encdec")
        self.cfg = cfg
        dev = resolve_device(device)
        dt = _dtype(cfg.dtype)
        self.embed = _param((cfg.padded_vocab, cfg.d_model), dt, dev)
        self.blocks = nn.ModuleList(Block(cfg, kind, dt, dev)
                                    for kind in cfg.layer_kinds())
        self.final_norm = Norm(cfg, dt, dev)
        self.lm_head_w = (None if cfg.tie_embeddings else
                          _param((cfg.d_model, cfg.padded_vocab), dt, dev))

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def param_specs(self) -> dict:
        """:func:`param_specs` of this model."""
        return param_specs(self)

    def init_params(self, gen: torch.Generator) -> "Transformer":
        """Fill every parameter from ``gen`` (a generator on the model's
        device): embedding N(0, 0.02), dense weights truncated normal at
        fan-in scale, norm scales 1, biases 0 (the mixers' own inits in
        :mod:`.mamba` and :mod:`.xlstm`)."""
        embed_init_(self.embed, gen)
        for blk in self.blocks:
            blk.init_params(gen)
        self.final_norm.init_params()
        if self.lm_head_w is not None:
            dense_init_(self.lm_head_w, gen)
        return self

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """The embedding rows of ``tokens``. On DTensors the lookup's
        backward, an ``index_put``, gets its operands in layouts PyTorch
        2.11's DTensor has a strategy for: the token ids replicated first,
        and the rows' gradient laid out as the rows were (the trunk's batch
        sharded over two mesh dims, as xlstm trains, has none)."""
        return grad_as_forward(self.embed[replicate(tokens.long())])

    def lm_head(self) -> torch.Tensor:
        """``[d, V]``: the tied embedding's transpose or the head weight."""
        return self.embed.t() if self.lm_head_w is None else self.lm_head_w

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        """The lm-head product in the model dtype, then f32."""
        return (self.final_norm(h) @ self.lm_head()).float()

    def _angles(self, start: int, n: int,
                positions3: torch.Tensor | None = None):
        """Rotary angles of positions ``start .. start+n-1`` (``[n,
        dh/2]``), or with M-RoPE's ``positions3 [3, B, n]`` per row
        (``[B, n, dh/2]``). Without ``positions3`` M-RoPE's angles are
        RoPE's, bitwise (text positions: t == h == w)."""
        cfg = self.cfg
        if cfg.rope_type == "none":
            return None
        if positions3 is not None:
            if cfg.rope_type != "mrope":
                raise ValueError(f"{cfg.name}: positions3 needs M-RoPE")
            return mrope_angles(positions3.to(self.device), cfg.head_dim,
                                cfg.rope_theta, cfg.mrope_sections)
        pos = torch.arange(start, start + n, device=self.device)
        return rope_angles(pos, cfg.head_dim, cfg.rope_theta)

    def init_decode_state(self, batch_size: int, max_len: int) -> dict:
        """Zeroed caches ``[B, T, Hkv, dh]`` per attention layer (``T`` =
        :func:`cache_len`), zeroed carries per recurrent layer, ``pos`` 0,
        on the model's device (on ``meta`` for a model built there: shapes
        and dtypes, no storage), through ``decode_state_constraint`` (the
        identity unless a dry-run cell installs it)."""
        T = cache_len(self.cfg, max_len)
        sh = (batch_size, T, self.cfg.n_kv_heads, self.cfg.head_dim)
        zeros = lambda: torch.zeros(sh, dtype=self.dtype, device=self.device)
        blocks = []
        for blk in self.blocks:
            mix = blk.kind["mix"]
            if mix == "attn":
                blocks.append({"k": zeros(), "v": zeros()})
            elif mix == "mamba":
                blocks.append(mamba_state_init(batch_size, blk.mix.p(),
                                               blk.mix.d_state))
            elif mix == "mlstm":
                blocks.append(mlstm_state_init(batch_size, blk.mix.p()))
            else:
                blocks.append(slstm_state_init(batch_size, blk.mix.p()))
        return decode_state_constraint({"blocks": blocks, "pos": 0},
                                       self.decode_state_specs)

    def decode_state_specs(self) -> dict:
        """The logical axes of every leaf of :meth:`init_decode_state`'s
        state, ``{"blocks": [one dict a layer], "pos": ()}``: the
        reference's ``decode_state_specs`` without the leading
        ``"layers"`` of its period-stacked leaves, as :func:`param_specs`
        gives the parameters'."""
        return {"blocks": [dict(STATE_SPECS[blk.kind["mix"]])
                           for blk in self.blocks], "pos": ()}

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, state: dict):
        """One token for every stream: ``token [B]`` -> ``(logits [B, V]
        float32, state)``; the state is updated in place. Under a sliding
        window the token's K/V go to slot ``pos % T`` and attention reads
        the ``min(pos + 1, T)`` filled slots (the buffer holds the
        window)."""
        pos = state["pos"]
        x = self.embed_tokens(token[:, None])              # [B,1,D]
        B = x.shape[0]
        angles = self._angles(pos, 1)
        for blk, st in zip(self.blocks, state["blocks"]):
            y = blk.norm1(x)
            mix = blk.kind["mix"]
            if mix == "attn":
                q, k, v = blk.mix.qkv(y, angles)
                T = st["k"].shape[1]
                slot = pos % T if self.cfg.sliding_window else pos
                st["k"][:, slot] = k[:, 0]
                st["v"][:, slot] = v[:, 0]
                o = decode_attention(q, st["k"], st["v"], min(pos + 1, T),
                                     softcap=self.cfg.attn_logit_softcap)
                o = o.reshape(B, 1, -1) @ blk.mix.wo
            else:
                if mix == "mamba":
                    o, new = mamba_decode_step(blk.mix.p(), y, st,
                                               blk.mix.d_state)
                else:
                    step = (mlstm_decode_step if mix == "mlstm"
                            else slstm_decode_step)
                    o, new = step(blk.mix.p(), y, st)
                st.update(new)
            x = blk.feed_forward(x + o)
        state["pos"] = pos + 1
        return self._logits(x[:, 0]), state

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int,
                positions3: torch.Tensor | None = None,
                embeds: torch.Tensor | None = None):
        """``tokens [B, S]`` -> ``(last-token logits [B, V] float32, decode
        state at pos = S)``, the whole prompt in one pass. ``embeds [B, S,
        D]`` (a stub frontend's patch / text embeddings) replace the token
        embeddings; ``positions3 [3, B, S]`` are M-RoPE's (t, h, w) ids.
        Under a sliding window attention is masked to it and, when ``S >=
        T``, the cache keeps the last ``T`` tokens rolled so that token
        ``j`` sits at slot ``j % T``."""
        B, S = tokens.shape
        x = (self.embed_tokens(tokens) if embeds is None
             else embeds.to(device=self.device, dtype=self.dtype))
        angles = self._angles(0, S, positions3)
        state = self.init_decode_state(B, max_len)
        for blk, st in zip(self.blocks, state["blocks"]):
            y = blk.norm1(x)
            mix = blk.kind["mix"]
            if mix == "attn":
                q, k, v = blk.mix.qkv(y, angles)
                o = blocked_attention(q, k, v,
                                      window=self.cfg.sliding_window,
                                      softcap=self.cfg.attn_logit_softcap)
                o = o.reshape(B, S, -1) @ blk.mix.wo
                T = st["k"].shape[1]
                if S >= T:
                    # rolled so that token j sits at slot j % T; a shift
                    # of 0 copies as it is (PyTorch 2.11's DTensor has no
                    # roll)
                    shift = (S - T) % T
                    roll = ((lambda t: torch.roll(t, shift, 1)) if shift
                            else (lambda t: t))
                    st["k"].copy_(roll(k[:, S - T:]))
                    st["v"].copy_(roll(v[:, S - T:]))
                else:
                    st["k"][:, :S] = k
                    st["v"][:, :S] = v
            else:
                p = blk.mix.p()
                if mix == "mamba":
                    o, new = apply_mamba(p, y, blk.mix.d_state,
                                         return_state=True)
                else:
                    fn = apply_mlstm if mix == "mlstm" else apply_slstm
                    o, new = fn(p, y, return_state=True)
                st.update(new)
            x = blk.feed_forward(x + o)
        state["pos"] = S
        return self._logits(x[:, -1]), state

    def _train_block(self, blk: Block, x: torch.Tensor, angles):
        """One block as the reference's ``_block_apply`` for training:
        ``(x, MoE aux loss)``."""
        B, S = x.shape[:2]
        y = matmul_input_constraint(blk.norm1(x))
        mix = blk.kind["mix"]
        if mix == "attn":
            q, k, v = attn_constraint(*blk.mix.qkv(y, angles))
            o = train_attention(q, k, v, window=self.cfg.sliding_window,
                                softcap=self.cfg.attn_logit_softcap)
            # the gradient reaches the flatten in the heads' layout
            o = grad_as_forward(o.reshape(B, S, -1)) @ blk.mix.wo
        elif mix == "mamba":
            o = apply_mamba_train(blk.mix.p(), y, blk.mix.d_state)
        elif mix == "mlstm":
            o = apply_mlstm_train(blk.mix.p(), y)
        else:
            o = apply_slstm_train(blk.mix.p(), y)
        x = x + matmul_input_constraint(o)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if blk.ff is not None:
            y2 = matmul_input_constraint(blk.norm2(x))
            if isinstance(blk.ff, MoE):
                o, aux = blk.ff.forward_train(y2)
            else:
                o = blk.ff(y2)
            x = x + matmul_input_constraint(o)
        return x, aux

    def train_forward(self, batch: dict) -> torch.Tensor:
        """The training loss of ``batch``: ``tokens`` / ``targets`` /
        ``mask [B, S]`` (and optionally ``embeds [B, S, D]``, a stub
        frontend's, and M-RoPE's ``positions3 [3, B, S]``) -> the mean
        masked next-token NLL over :func:`chunked_ce_loss` plus 0.01 times
        the MoE layers' aux losses, a float32 0-dim tensor that autograd
        differentiates. The trunk as the reference's ``forward_hidden``:
        each block under ``torch.utils.checkpoint`` when ``cfg.remat``, the
        activation constraint at each period boundary."""
        cfg = self.cfg
        P = cfg.scan_period()
        tokens = batch["tokens"].to(self.device)
        S = tokens.shape[1]
        x = (batch["embeds"].to(device=self.device, dtype=self.dtype)
             if "embeds" in batch else self.embed_tokens(tokens))
        positions3 = batch.get("positions3")
        angles = self._angles(0, S, positions3)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for i, blk in enumerate(self.blocks):
            if cfg.remat:
                x, a = checkpoint(self._train_block, blk, x, angles,
                                  use_reentrant=False)
            else:
                x, a = self._train_block(blk, x, angles)
            aux = aux + a
            if (i + 1) % P == 0:
                x = activation_constraint(x)
        h = self.final_norm(x)
        loss = chunked_ce_loss(h, self.lm_head(),
                               batch["targets"].to(self.device),
                               batch["mask"].to(self.device))
        return loss + 0.01 * aux
