"""Architecture registry of the port: the reference's names and all ten
of its configs.

``get_config(arch)`` returns the published dims; ``get_smoke_config`` a
family-preserving reduction (same layer pattern, tiny widths) for CPU
tests. The names and aliases are the reference's (``repro.configs``). The
reference's input-shape specs lower through XLA and have no counterpart
here.
"""

from __future__ import annotations

import importlib

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
