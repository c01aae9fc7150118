"""Architecture registry of the port: the reference's names and all ten
of its configs.

``get_config(arch)`` returns the published dims; ``get_smoke_config`` a
family-preserving reduction (same layer pattern, tiny widths) for CPU
tests. The names and aliases are the reference's (``repro.configs``).
``SHAPES`` carries the reference's input-shape set and ``input_specs(arch,
shape)`` the inputs of one (arch x shape) cell of the dry run
(``repro_torch.launch.dryrun``), as tensors on the ``meta`` device (shape
and dtype, no storage) where the reference builds ``ShapeDtypeStruct``s;
the decode state is the port's model's own (``init_decode_state`` on a
model built on ``meta``). ``long_500k`` needs sub-quadratic attention: it
runs for SSM / hybrid / sliding-window archs and is skipped, with the
reference's reason, for pure full-attention ones.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.config import ModelConfig

ARCHS = [
    "qwen2_vl_72b", "jamba_v01_52b", "llama4_maverick_400b",
    "phi35_moe_42b", "stablelm_12b", "qwen2_72b", "qwen2_5_3b",
    "h2o_danube3_4b", "seamless_m4t_medium", "xlstm_350m",
]

# accept dashed ids from the assignment table too
ALIASES = {
    "qwen2-vl-72b": "qwen2_vl_72b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "stablelm-12b": "stablelm_12b",
    "qwen2-72b": "qwen2_72b",
    "qwen2.5-3b": "qwen2_5_3b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "xlstm-350m": "xlstm_350m",
}

#: configs ported (all of ``ARCHS``)
PORTED = tuple(ARCHS)


def canonical(arch: str) -> str:
    return ALIASES.get(arch, arch)


def _module(arch: str):
    name = canonical(arch)
    if name not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; expected one of {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def supports_long_context(cfg: ModelConfig) -> bool:
    """Sub-quadratic decode state: SSM / hybrid families or SWA."""
    return cfg.family in ("ssm", "hybrid") or cfg.sliding_window > 0


def skip_reason(cfg: ModelConfig, shape: str) -> str | None:
    if shape == "long_500k" and not supports_long_context(cfg):
        return ("pure full-attention arch: 500K KV decode needs "
                "sub-quadratic attention")
    return None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _stub_inputs(cfg: ModelConfig, B: int, S: int) -> dict:
    """The stub frontends' inputs: the encoder-decoder's audio frames, the
    M-RoPE family's patch / text embeddings and position ids."""
    dt = getattr(torch, cfg.dtype)
    specs = {}
    if cfg.family == "encdec":
        specs["frames"] = _meta((B, S, cfg.d_model), dt)
    if cfg.rope_type == "mrope":
        specs["embeds"] = _meta((B, S, cfg.d_model), dt)
        specs["positions3"] = _meta((3, B, S), torch.int32)
    return specs


def train_batch_specs(cfg: ModelConfig, B: int, S: int) -> dict:
    return {"tokens": _meta((B, S), torch.int32),
            "targets": _meta((B, S), torch.int32),
            "mask": _meta((B, S), torch.float32), **_stub_inputs(cfg, B, S)}


def decode_input_specs(cfg: ModelConfig, B: int, S: int) -> dict:
    """The token and the port's decode state at context ``S`` (built on
    ``meta`` by the model's own ``init_decode_state``)."""
    from repro_torch.models import build_model
    model = build_model(cfg, device="meta", seed=None)
    state = (model.init_decode_state(B, S, S) if cfg.family == "encdec"
             else model.init_decode_state(B, S))
    return {"token": _meta((B,), torch.int32), "state": state}


def prefill_input_specs(cfg: ModelConfig, B: int, S: int) -> dict:
    return {"tokens": _meta((B, S), torch.int32), **_stub_inputs(cfg, B, S)}


def input_specs(arch: str, shape: str, smoke: bool = False) -> dict:
    """Everything the dry run needs for one (arch x shape) cell."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    sp = SHAPES[shape]
    reason = skip_reason(cfg, shape)
    out = {"cfg": cfg, "shape": sp, "skip": reason}
    if reason:
        return out
    if sp.kind == "train":
        out["batch"] = train_batch_specs(cfg, sp.global_batch, sp.seq_len)
    elif sp.kind == "prefill":
        out["batch"] = prefill_input_specs(cfg, sp.global_batch, sp.seq_len)
    else:
        out["batch"] = decode_input_specs(cfg, sp.global_batch, sp.seq_len)
    return out
