"""Decoder-only LM, dense, MoE and hybrid families: one block module per
layer.

Counterpart of ``repro.models.transformer``. The reference stacks the
parameters of each position of the layer pattern ``[n_periods, ...]`` and
scans over periods; eager PyTorch has no use for that, so here every layer
is its own :class:`Block` and the trunk is a Python loop.
``repro_torch.convert.model_params_from_jax`` unstacks the reference's
parameters into this layout.

Entry points, as the reference's: :meth:`Transformer.init_params`,
:meth:`~Transformer.embed_tokens`, :meth:`~Transformer.lm_head`,
:meth:`~Transformer.init_decode_state`, :meth:`~Transformer.decode_step`
(one token + state -> logits + state) and :meth:`~Transformer.prefill`
(tokens -> last logits + decode state). The decode state is
``{"blocks": [one dict per layer], "pos": int}``: an attention layer holds
its caches ``{"k", "v"}`` ``[B, T, Hkv, dh]``, a Mamba layer its carry
``{"conv" [B, K-1, di], "h" [B, di, N] float32}``. ``decode_step`` updates
the per-layer dicts **in place** (K/V written into the caches) and
advances ``pos`` (the reference returns a new state), which saves a cache
copy per token. ``pos`` is a host int, so no step waits on the device to
learn it.

What is built: the dense family's qwen2-style configs (attention layers
with a SwiGLU MLP, RMSNorm, RoPE); the MoE family (attention layers whose
feed-forward is an MLP or a MoE as ``cfg.layer_kinds()`` interleaves them
by ``moe_every`` / ``moe_offset``, with the shared expert of
``n_shared_experts``: phi3.5-moe has a MoE on every layer, llama4-maverick
on every second, odd, layer); and the hybrid family of jamba (Mamba or
attention mixers, MLP or MoE feed-forwards, ``rope_type="none"``).
Prefill attention goes through the flash-attention kernel on the card;
Mamba prefill through the selective-scan kernel. xLSTM layers, the
encoder-decoder family, M-RoPE, LayerNorm, GeGLU (and a GELU MoE),
sliding windows and logit soft-capping raise ``NotImplementedError``
(ROADMAP queue 1 item 3).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device

from .attention import causal_attention, decode_attention
from .config import ModelConfig
from .layers import (apply_mlp, apply_norm, apply_rotary, dense_init_,
                     embed_init_, norm_init_, rope_angles)
from .mamba import (F32_LEAVES, apply_mamba, mamba_decode_step, mamba_init_,
                    mamba_shapes, mamba_state_init)
from .moe import apply_moe


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def _dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port cannot build yet."""
    later = {"the encoder-decoder family": cfg.family == "encdec",
             f"rope_type={cfg.rope_type!r}": cfg.rope_type == "mrope",
             f"norm={cfg.norm!r}": cfg.norm != "rmsnorm",
             f"act={cfg.act!r}": cfg.act != "silu",
             "sliding-window attention": bool(cfg.sliding_window),
             "attention logit soft-capping": bool(cfg.attn_logit_softcap)}
    for what, hit in later.items():
        if hit:
            raise NotImplementedError(
                f"{cfg.name}: {what} is ported in a later slice (ROADMAP "
                "queue 1 item 3)")
    for kind in cfg.layer_kinds():
        if kind["mix"] not in ("attn", "mamba"):
            raise NotImplementedError(
                f"{cfg.name}: {kind['mix']} layers are ported in a later "
                "slice (ROADMAP queue 1 item 3)")


class Norm(nn.Module):
    """RMSNorm with a ``scale [d]``."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.eps = cfg.norm_eps
        self.scale = _param((cfg.d_model,), dtype, device)

    def init_params(self) -> None:
        norm_init_(self.scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_norm(self.scale, x, self.eps)


class Attention(nn.Module):
    """``wq [d, Hq*dh]``, ``wk``/``wv [d, Hkv*dh]``, ``wo [Hq*dh, d]``
    (``[d_in, d_out]``), with the QKV biases when the config has them."""

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

    def qkv(self, y: torch.Tensor, angles: torch.Tensor | None):
        """y [B,S,d] -> q [B,S,Hq,dh], k/v [B,S,Hkv,dh]; q and k roped
        unless ``angles`` is ``None`` (``rope_type="none"``)."""
        B, S, _ = y.shape
        q, k, v = y @ self.wq, y @ self.wk, y @ self.wv
        if self.bq is not None:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q = q.reshape(B, S, self.n_heads, self.head_dim)
        k = k.reshape(B, S, self.n_kv_heads, self.head_dim)
        v = v.reshape(B, S, self.n_kv_heads, self.head_dim)
        if angles is None:
            return q, k, v
        a = angles[None, :, None, :]                     # [1,S,1,half]
        return apply_rotary(q, a), apply_rotary(k, a), v


class MLP(nn.Module):
    """SwiGLU: ``wg``/``wu [d, ff]``, ``wd [ff, d]``; ``ff`` is
    ``cfg.d_ff`` unless given (a MoE's shared expert)."""

    def __init__(self, cfg: ModelConfig, dtype, device,
                 ff: int | None = None):
        super().__init__()
        ff = cfg.d_ff if ff is None else ff
        self.wg = _param((cfg.d_model, ff), dtype, device)
        self.wu = _param((cfg.d_model, ff), dtype, device)
        self.wd = _param((ff, cfg.d_model), dtype, device)

    def init_params(self, gen: torch.Generator) -> None:
        for w in (self.wg, self.wu, self.wd):
            dense_init_(w, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_mlp(self.wg, self.wu, self.wd, x)


class Mamba(nn.Module):
    """The Mamba mixer's leaves (:mod:`.mamba`), ``a_log`` / ``dt_bias`` /
    ``d_skip`` in float32."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.d_state = cfg.mamba_d_state
        shapes = mamba_shapes(cfg.d_model, cfg.mamba_expand,
                              cfg.mamba_d_state, cfg.mamba_d_conv)
        self.names = tuple(shapes)
        for name, sh in shapes.items():
            setattr(self, name, _param(
                sh, torch.float32 if name in F32_LEAVES else dtype, device))

    def p(self) -> dict:
        return {n: getattr(self, n) for n in self.names}

    def init_params(self, gen: torch.Generator) -> None:
        mamba_init_(self.p(), gen)


class MoE(nn.Module):
    """Router ``wr [d, E]`` and experts ``wg`` / ``wu [E, d, F]``,
    ``wd [E, F, d]`` (:mod:`.moe`); with ``n_shared_experts`` a ``shared``
    :class:`MLP` of width ``F * n_shared_experts``."""

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


class Block(nn.Module):
    """One layer: ``norm1 -> mix (attention or Mamba) -> norm2 -> ff (MLP
    or MoE)``, each a residual branch (the reference's parameter tree
    names)."""

    def __init__(self, cfg: ModelConfig, kind: dict, dtype, device):
        super().__init__()
        self.kind = kind
        self.norm1 = Norm(cfg, dtype, device)
        self.mix = (Attention(cfg, dtype, device) if kind["mix"] == "attn"
                    else Mamba(cfg, dtype, device))
        self.norm2 = Norm(cfg, dtype, device)
        self.ff = (MLP(cfg, dtype, device) if kind["ff"] == "mlp"
                   else MoE(cfg, dtype, device))

    def init_params(self, gen: torch.Generator) -> None:
        self.norm1.init_params()
        self.mix.init_params(gen)
        self.norm2.init_params()
        self.ff.init_params(gen)


class Transformer(nn.Module):
    """The decoder-only LM of ``cfg``, parameters in ``cfg.dtype`` on
    ``device`` (``None``: CUDA), left uninitialised until
    :meth:`init_params` or a conversion fills them."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        cfg.validate()
        check_supported(cfg)
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

    def init_params(self, gen: torch.Generator) -> "Transformer":
        """Fill every parameter from ``gen`` (a generator on the model's
        device): embedding N(0, 0.02), dense weights truncated normal at
        fan-in scale, norm scales 1, biases 0."""
        embed_init_(self.embed, gen)
        for blk in self.blocks:
            blk.init_params(gen)
        self.final_norm.init_params()
        if self.lm_head_w is not None:
            dense_init_(self.lm_head_w, gen)
        return self

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed[tokens.long()]

    def lm_head(self) -> torch.Tensor:
        """``[d, V]``: the tied embedding's transpose or the head weight."""
        return self.embed.t() if self.lm_head_w is None else self.lm_head_w

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        """The lm-head product in the model dtype, then f32."""
        return (self.final_norm(h) @ self.lm_head()).float()

    def _angles(self, start: int, n: int) -> torch.Tensor | None:
        if self.cfg.rope_type == "none":
            return None
        pos = torch.arange(start, start + n, device=self.device)
        return rope_angles(pos, self.cfg.head_dim, self.cfg.rope_theta)

    def init_decode_state(self, batch_size: int, max_len: int) -> dict:
        """Zeroed caches ``[B, max_len, Hkv, dh]`` per attention layer and
        zeroed carries per Mamba layer, ``pos`` 0."""
        sh = (batch_size, max_len, self.cfg.n_kv_heads, self.cfg.head_dim)
        zeros = lambda: torch.zeros(sh, dtype=self.dtype, device=self.device)
        blocks = []
        for blk in self.blocks:
            if blk.kind["mix"] == "attn":
                blocks.append({"k": zeros(), "v": zeros()})
            else:
                blocks.append(mamba_state_init(batch_size, blk.mix.p(),
                                               blk.mix.d_state))
        return {"blocks": blocks, "pos": 0}

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, state: dict):
        """One token for every stream: ``token [B]`` -> ``(logits [B, V]
        float32, state)``; the state is updated in place."""
        pos = state["pos"]
        x = self.embed_tokens(token[:, None])              # [B,1,D]
        B = x.shape[0]
        angles = self._angles(pos, 1)
        for blk, st in zip(self.blocks, state["blocks"]):
            y = blk.norm1(x)
            if blk.kind["mix"] == "attn":
                q, k, v = blk.mix.qkv(y, angles)
                st["k"][:, pos] = k[:, 0]
                st["v"][:, pos] = v[:, 0]
                o = decode_attention(q, st["k"], st["v"], pos + 1)
                x = x + o.reshape(B, 1, -1) @ blk.mix.wo
            else:
                o, new = mamba_decode_step(blk.mix.p(), y, st,
                                           blk.mix.d_state)
                st.update(new)
                x = x + o
            x = x + blk.ff(blk.norm2(x))
        state["pos"] = pos + 1
        return self._logits(x[:, 0]), state

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int):
        """``tokens [B, S]`` -> ``(last-token logits [B, V] float32, decode
        state at pos = S)``, the whole prompt in one causal pass."""
        B, S = tokens.shape
        x = self.embed_tokens(tokens)
        angles = self._angles(0, S)
        state = self.init_decode_state(B, max_len)
        for blk, st in zip(self.blocks, state["blocks"]):
            y = blk.norm1(x)
            if blk.kind["mix"] == "attn":
                q, k, v = blk.mix.qkv(y, angles)
                o = causal_attention(q, k, v)
                x = x + o.reshape(B, S, -1) @ blk.mix.wo
                st["k"][:, :S] = k
                st["v"][:, :S] = v
            else:
                o, new = apply_mamba(blk.mix.p(), y, blk.mix.d_state,
                                     return_state=True)
                st.update(new)
                x = x + o
            x = x + blk.ff(blk.norm2(x))
        state["pos"] = S
        return self._logits(x[:, -1]), state
