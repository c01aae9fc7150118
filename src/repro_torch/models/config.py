"""ModelConfig — one schema covering every assigned architecture family.

A copy of ``repro.models.config`` (framework-neutral); the port keeps its
own so that it imports nothing of the reference. The port's model code
builds every family (``repro_torch.models.transformer``, ``.encdec``).

The config is deliberately flat: family-specific knobs default to "off" so a
dense transformer is the zero case. ``layer_kinds()`` expands the interleave
knobs into the explicit per-layer pattern; ``scan_period()`` is the period
the reference stacks its parameters by (and the port's converter unstacks);
``param_count()`` gives the N used by the roofline's MODEL_FLOPS = 6·N·D
(dense) / 6·N_active·D (MoE) sanity ratio.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

Family = Literal["dense", "moe", "hybrid", "ssm", "encdec"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family = "dense"

    # -- trunk dimensions ---------------------------------------------------
    n_layers: int = 12
    d_model: int = 512
    n_heads: int = 8
    n_kv_heads: int = 8
    d_head: int = 0                   # 0 -> d_model // n_heads
    d_ff: int = 2048
    vocab_size: int = 32000

    # -- attention ----------------------------------------------------------
    qkv_bias: bool = False            # qwen2 family
    rope_theta: float = 10_000.0
    rope_type: Literal["rope", "mrope", "none"] = "rope"
    mrope_sections: tuple[int, int, int] = (16, 24, 24)   # t/h/w (qwen2-vl)
    sliding_window: int = 0           # 0 = full attention (h2o-danube: SWA)
    attn_logit_softcap: float = 0.0

    # -- interleave patterns (hybrid / MoE / xLSTM) ---------------------------
    attn_every: int = 1               # jamba: 8 (1 attn : 7 mamba)
    attn_offset: int = 0              # jamba: 4
    moe_every: int = 0                # 0 = no MoE; llama4: 2; jamba: 2; phi: 1
    moe_offset: int = 0
    slstm_every: int = 0              # xlstm: 8 (1 sLSTM : 7 mLSTM)
    slstm_offset: int = 0

    # -- MoE ------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0              # 0 -> d_ff
    n_shared_experts: int = 0         # llama4: 1 shared expert
    capacity_factor: float = 1.25

    # -- Mamba (jamba) --------------------------------------------------------
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # -- xLSTM ----------------------------------------------------------------
    xlstm_proj_factor: float = 2.0    # mLSTM up-projection
    xlstm_conv: int = 4

    # -- encoder-decoder ------------------------------------------------------
    n_enc_layers: int = 0             # encdec: encoder depth (n_layers = decoder)

    # -- misc -----------------------------------------------------------------
    vocab_pad: int = 0                # pad embedding rows for TP divisibility
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    act: Literal["silu", "gelu"] = "silu"
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"           # param/compute dtype (tests use float32)
    remat: bool = True                # activation checkpointing in the scan

    # ------------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return self.vocab_size + self.vocab_pad

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def ff_expert(self) -> int:
        return self.d_ff_expert or self.d_ff

    def layer_kinds(self) -> list[dict]:
        """Expand interleave knobs -> per-layer {'mix': .., 'ff': ..} kinds.

        mix in {'attn','mamba','mlstm','slstm'}; ff in {'mlp','moe','none'}.
        """
        kinds = []
        for i in range(self.n_layers):
            if self.family == "ssm":
                mix = ("slstm" if self.slstm_every
                       and i % self.slstm_every == self.slstm_offset else "mlstm")
                ff = "mlp" if self.d_ff else "none"
            elif self.family == "hybrid":
                mix = ("attn" if i % self.attn_every == self.attn_offset
                       else "mamba")
                ff = ("moe" if self.moe_every
                      and i % self.moe_every == self.moe_offset else "mlp")
            else:
                mix = "attn"
                ff = ("moe" if self.moe_every
                      and i % self.moe_every == self.moe_offset else "mlp")
            kinds.append({"mix": mix, "ff": ff})
        return kinds

    def scan_period(self) -> int:
        """Smallest period the layer pattern repeats with (for period-scan)."""
        period = 1
        for knob in (self.attn_every if self.family == "hybrid" else 1,
                     self.moe_every or 1, self.slstm_every or 1):
            period = math.lcm(period, knob)
        # the pattern must tile n_layers exactly; a stack shorter than
        # the pattern is one period (the reference's loop never ends there)
        period = min(period, max(self.n_layers, 1))
        while self.n_layers % period:
            period += 1
        return period

    # ------------------------------------------------------------------------
    def param_count(self) -> tuple[int, int]:
        """(total, active) parameter counts — embeddings included in total.

        Active = params touched per token (MoE: top_k + shared experts only).
        """
        d, h = self.d_model, self.head_dim
        total = active = 0

        def add(n, is_active=True):
            nonlocal total, active
            total += n
            if is_active:
                active += n

        # embeddings (+ untied LM head)
        add(self.vocab_size * d)
        if not self.tie_embeddings:
            add(self.vocab_size * d)

        def attn_params():
            n = d * (self.n_heads * h) + 2 * d * (self.n_kv_heads * h) + (self.n_heads * h) * d
            if self.qkv_bias:
                n += self.n_heads * h + 2 * self.n_kv_heads * h
            return n

        def mlp_params(ff):
            return 3 * d * ff        # gate/up/down (SwiGLU)

        def mamba_params():
            di = self.mamba_expand * d
            dt_rank = -(-d // 16)                # ceil(d/16), mamba default
            n = d * 2 * di                       # in_proj (x, z)
            n += di * self.mamba_d_conv          # depthwise conv
            n += di * (dt_rank + 2 * self.mamba_d_state)  # x -> (dt, B, C)
            n += dt_rank * di + di               # dt_proj + bias
            n += di * self.mamba_d_state         # A (log)
            n += di                              # D
            n += di * d                          # out_proj
            return n

        def mlstm_params():
            di = int(self.xlstm_proj_factor * d)
            dh = di // self.n_heads
            # up/gate proj; block-diag q/k/v; i/f gates; o proj; down proj
            return (d * 2 * di + 3 * self.n_heads * dh * dh
                    + 2 * self.n_heads + di * di + di * d)

        def slstm_params():
            # 4 gates x (recurrent + input) at model width, heads block-diagonal
            return 4 * d * d + 4 * d * (d // max(1, self.n_heads)) + d * d

        for kind in self.layer_kinds():
            if kind["mix"] == "attn":
                add(attn_params())
            elif kind["mix"] == "mamba":
                add(mamba_params())
            elif kind["mix"] == "mlstm":
                add(mlstm_params())
            elif kind["mix"] == "slstm":
                add(slstm_params())
            if kind["ff"] == "mlp":
                add(mlp_params(self.d_ff))
            elif kind["ff"] == "moe":
                e = mlp_params(self.ff_expert)
                total += self.n_experts * e
                active += min(self.top_k, self.n_experts) * e
                if self.n_shared_experts:
                    add(self.n_shared_experts * e)
                add(d * self.n_experts)          # router
        # encoder stack (encdec): mirror of decoder without cross-attn scaling
        if self.family == "encdec" and self.n_enc_layers:
            per = attn_params() + mlp_params(self.d_ff)
            add(self.n_enc_layers * per)
            add(self.n_layers * attn_params())   # decoder cross-attention
        return total, active

    def validate(self) -> None:
        """Raise ``ValueError`` on dims no model can be built from."""
        checks = [
            (self.d_model % self.n_heads == 0 or self.d_head,
             "d_model must divide by n_heads (or set d_head)"),
            (self.n_heads % self.n_kv_heads == 0,
             "n_heads must divide by n_kv_heads"),
            (not self.moe_every or self.n_experts >= self.top_k > 0,
             "MoE needs n_experts >= top_k > 0"),
            (self.n_layers % self.scan_period() == 0,
             "n_layers must tile by the scan period"),
        ]
        for ok, msg in checks:
            if not ok:
                raise ValueError(f"{self.name}: {msg}")
