"""Encoder-decoder (seamless-m4t backbone): a bidirectional encoder and a
causal decoder with cross-attention.

Counterpart of ``repro.models.encdec``. The audio frontend is a stub, as
there: the encoder takes precomputed frame embeddings ``frames [B, Se, D]``
through an input projection ``in_proj [D, D]``, a stack of ``enc`` blocks
(``norm1 -> attn`` bidirectional, ``norm2 -> ff``) and ``enc_norm``. The
decoder embeds tokens and runs ``dec`` blocks (``norm1 -> self`` causal,
``normx -> cross`` against the encoder output, ``norm2 -> ff``), then
``final_norm`` and the head. Self-attention in both stacks is roped and
goes through the flash kernel (the reference's ``blocked_attention``);
cross-attention is not roped, and at prefill goes through the same kernel
unmasked (the reference computes it with ``full_attention``, the
materialised-scores form of the same function).

The decode state is the reference's: ``{"self_kv": {"k", "v"} [L, B,
max_len, Hkv, dh], "cross_kv": {"k", "v"} [L, B, Se, Hkv, dh], "pos"}``.
The cross K/V are computed once at prefill and stay static;
:meth:`EncDec.decode_step` writes the token's self K/V in place and
advances the host int ``pos``, as :class:`Transformer` does.

:meth:`EncDec.train_forward` is the reference's: ``encode``, then the
decoder's hidden states, then ``chunked_ce_loss`` over the tied or untied
head, through autograd. The flash kernel is forward-only, so training
takes ``attention.train_attention`` for both self-attentions and the
cross-attention (the reference differentiates its jnp
``blocked_attention`` and ``full_attention``, the same functions), and
each encoder and decoder block runs under ``torch.utils.checkpoint`` when
``cfg.remat`` is set. ``batch["frames"]`` is the stub frontend's ``[B, S,
D]``; a batch without it raises ``KeyError``, as the reference's does
(its train CLI's pipeline gives none). Each block's output goes through
``activation_constraint`` (the identity unless the sharded train step
installs it), as the reference's ``encode`` and ``decode_hidden`` pin
theirs.
"""

from __future__ import annotations

import torch
from torch import nn

from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed.activations import (activation_constraint,
                                                 decode_state_constraint)

from .attention import blocked_attention, decode_attention, train_attention
from .config import ModelConfig
from .layers import chunked_ce_loss, dense_init_, embed_init_, rope_angles
from .transformer import MLP, Attention, Norm, _dtype, _param, param_specs


class EncBlock(nn.Module):
    """``norm1``, ``attn``, ``norm2``, ``ff``: the reference's names."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.norm1 = Norm(cfg, dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.norm2 = Norm(cfg, dtype, device)
        self.ff = MLP(cfg, dtype, device)

    def init_params(self, gen: torch.Generator) -> None:
        for m in (self.norm1, self.norm2):
            m.init_params()
        self.attn.init_params(gen)
        self.ff.init_params(gen)

    def forward(self, x: torch.Tensor, angles: torch.Tensor,
                attend=blocked_attention) -> torch.Tensor:
        """The block, its bidirectional attention through ``attend``
        (``train_attention`` on the train route)."""
        B, S = x.shape[:2]
        q, k, v = self.attn.qkv(self.norm1(x), angles)
        o = attend(q, k, v, causal=False)
        x = x + o.reshape(B, S, -1) @ self.attn.wo
        return activation_constraint(x + self.ff(self.norm2(x)))


class DecBlock(nn.Module):
    """``norm1``, ``self``, ``normx``, ``cross``, ``norm2``, ``ff``."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.norm1 = Norm(cfg, dtype, device)
        # ``self`` is the reference's leaf name; a module attribute may
        # not be called that in a method, hence setattr / getattr
        setattr(self, "self", Attention(cfg, dtype, device))
        self.normx = Norm(cfg, dtype, device)
        self.cross = Attention(cfg, dtype, device)
        self.norm2 = Norm(cfg, dtype, device)
        self.ff = MLP(cfg, dtype, device)

    @property
    def self_attn(self) -> Attention:
        return getattr(self, "self")

    def init_params(self, gen: torch.Generator) -> None:
        for m in (self.norm1, self.normx, self.norm2):
            m.init_params()
        self.self_attn.init_params(gen)
        self.cross.init_params(gen)
        self.ff.init_params(gen)

    def cross_ff(self, x: torch.Tensor, attend) -> torch.Tensor:
        """The cross-attention (``attend(q)`` over the encoder's K/V) and
        feed-forward residuals."""
        B, S = x.shape[:2]
        ox = attend(self.cross.q(self.normx(x)))
        x = x + ox.reshape(B, S, -1) @ self.cross.wo
        return x + self.ff(self.norm2(x))


class EncDec(nn.Module):
    """The encoder-decoder LM of ``cfg`` (``family="encdec"``), parameters
    in ``cfg.dtype`` on ``device`` (``None``: CUDA)."""

    SPECS = {"in_proj": ("embed", "embed"), "embed": ("vocab", "embed"),
             "lm_head_w": ("embed", "vocab")}

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        cfg.validate()
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.name}: family {cfg.family!r} is not "
                             "encdec")
        self.cfg = cfg
        dev = resolve_device(device)
        dt = _dtype(cfg.dtype)
        d = cfg.d_model
        self.in_proj = _param((d, d), dt, dev)
        self.enc = nn.ModuleList(EncBlock(cfg, dt, dev)
                                 for _ in range(cfg.n_enc_layers))
        self.enc_norm = Norm(cfg, dt, dev)
        self.embed = _param((cfg.padded_vocab, d), dt, dev)
        self.dec = nn.ModuleList(DecBlock(cfg, dt, dev)
                                 for _ in range(cfg.n_layers))
        self.final_norm = Norm(cfg, dt, dev)
        self.lm_head_w = (None if cfg.tie_embeddings else
                          _param((d, cfg.padded_vocab), dt, dev))

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def param_specs(self) -> dict:
        """Parameter name -> the reference's logical axes
        (``transformer.param_specs``)."""
        return param_specs(self)

    def init_params(self, gen: torch.Generator) -> "EncDec":
        """Fill every parameter from ``gen``: the reference's
        distributions, as :meth:`Transformer.init_params`."""
        dense_init_(self.in_proj, gen)
        for blk in (*self.enc, *self.dec):
            blk.init_params(gen)
        self.enc_norm.init_params()
        embed_init_(self.embed, gen)
        self.final_norm.init_params()
        if self.lm_head_w is not None:
            dense_init_(self.lm_head_w, gen)
        return self

    def lm_head(self) -> torch.Tensor:
        return self.embed.t() if self.lm_head_w is None else self.lm_head_w

    def _angles(self, start: int, n: int) -> torch.Tensor:
        pos = torch.arange(start, start + n, device=self.device)
        return rope_angles(pos, self.cfg.head_dim, self.cfg.rope_theta)

    def _dec_train_block(self, blk: DecBlock, x: torch.Tensor,
                         enc_out: torch.Tensor,
                         angles: torch.Tensor) -> torch.Tensor:
        """One decoder block as the reference's ``_dec_block``,
        differentiable."""
        B, S = x.shape[:2]
        q, k, v = blk.self_attn.qkv(blk.norm1(x), angles)
        o = train_attention(q, k, v)
        x = x + o.reshape(B, S, -1) @ blk.self_attn.wo
        kx, vx = blk.cross.kv(enc_out)
        x = blk.cross_ff(x, lambda qx: train_attention(qx, kx, vx,
                                                       causal=False))
        return activation_constraint(x)

    def _run(self, fn, *args):
        """``fn(*args)``, under ``torch.utils.checkpoint`` when
        ``cfg.remat``."""
        if self.cfg.remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def train_forward(self, batch: dict) -> torch.Tensor:
        """The training loss of ``batch``: ``frames [B, Se, D]``,
        ``tokens`` / ``targets`` / ``mask [B, S]`` -> the mean masked
        next-token NLL (:func:`chunked_ce_loss`), a float32 0-dim tensor
        that autograd differentiates."""
        x = batch["frames"].to(device=self.device,
                               dtype=self.dtype) @ self.in_proj
        angles = self._angles(0, x.shape[1])
        for blk in self.enc:
            x = self._run(blk, x, angles, train_attention)
        enc_out = self.enc_norm(x)
        tokens = batch["tokens"].to(self.device)
        x = self.embed[tokens.long()]
        angles = self._angles(0, tokens.shape[1])
        for blk in self.dec:
            x = self._run(self._dec_train_block, blk, x, enc_out, angles)
        return chunked_ce_loss(self.final_norm(x), self.lm_head(),
                               batch["targets"].to(self.device),
                               batch["mask"].to(self.device))

    @torch.no_grad()
    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """``frames [B, Se, D]`` -> encoder output ``[B, Se, D]``."""
        x = frames.to(device=self.device, dtype=self.dtype) @ self.in_proj
        angles = self._angles(0, x.shape[1])
        for blk in self.enc:
            x = blk(x, angles)
        return self.enc_norm(x)

    def init_decode_state(self, batch_size: int, max_len: int,
                          enc_len: int = 0) -> dict:
        """Zeroed self K/V ``[L, B, max_len, Hkv, dh]`` and cross K/V
        ``[L, B, enc_len or max_len, Hkv, dh]``, ``pos`` 0, through
        ``decode_state_constraint`` (the identity unless a dry-run cell
        installs it)."""
        cfg = self.cfg
        kv = lambda T: {k: torch.zeros(
            (cfg.n_layers, batch_size, T, cfg.n_kv_heads, cfg.head_dim),
            dtype=self.dtype, device=self.device) for k in ("k", "v")}
        return decode_state_constraint(
            {"self_kv": kv(max_len), "cross_kv": kv(enc_len or max_len),
             "pos": 0}, self.decode_state_specs)

    def decode_state_specs(self) -> dict:
        """The logical axes of every leaf of :meth:`init_decode_state`'s
        state: the reference's, whose K/V are stacked over the layers as
        the port's are."""
        kv = ("layers", "batch", "kv_seq", "kv_heads_s", None)
        return {"self_kv": {"k": kv, "v": kv},
                "cross_kv": {"k": kv, "v": kv}, "pos": ()}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int,
                frames: torch.Tensor):
        """Encode ``frames [B, Se, D]``, then the decoder over ``tokens
        [B, S]`` -> ``(last-token logits [B, V] float32, decode state at
        pos = S)``."""
        B, S = tokens.shape
        enc_out = self.encode(frames)
        state = self.init_decode_state(B, max_len, enc_out.shape[1])
        x = self.embed[tokens.long()]
        angles = self._angles(0, S)
        skv, xkv = state["self_kv"], state["cross_kv"]
        for layer, blk in enumerate(self.dec):
            q, k, v = blk.self_attn.qkv(blk.norm1(x), angles)
            o = blocked_attention(q, k, v)
            x = x + o.reshape(B, S, -1) @ blk.self_attn.wo
            skv["k"][layer, :, :S] = k
            skv["v"][layer, :, :S] = v
            kx, vx = blk.cross.kv(enc_out)
            xkv["k"][layer], xkv["v"][layer] = kx, vx
            x = blk.cross_ff(x, lambda qx: blocked_attention(
                qx, kx, vx, causal=False))
        state["pos"] = S
        return (self.final_norm(x[:, -1]) @ self.lm_head()).float(), state

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, state: dict):
        """``token [B]`` -> ``(logits [B, V] float32, state)``: self K/V
        appended in place, cross K/V static."""
        pos = state["pos"]
        x = self.embed[token.long()[:, None]]                # [B,1,D]
        B = x.shape[0]
        angles = self._angles(pos, 1)
        skv, xkv = state["self_kv"], state["cross_kv"]
        Se = xkv["k"].shape[2]
        for layer, blk in enumerate(self.dec):
            q, k, v = blk.self_attn.qkv(blk.norm1(x), angles)
            skv["k"][layer, :, pos] = k[:, 0]
            skv["v"][layer, :, pos] = v[:, 0]
            o = decode_attention(q, skv["k"][layer], skv["v"][layer],
                                 pos + 1)
            x = x + o.reshape(B, 1, -1) @ blk.self_attn.wo
            x = blk.cross_ff(x, lambda qx: decode_attention(
                qx, xkv["k"][layer], xkv["v"][layer], Se))
        state["pos"] = pos + 1
        return (self.final_norm(x[:, 0]) @ self.lm_head()).float(), state
