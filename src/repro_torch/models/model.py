"""build_model: the port's model of a config, its parameters drawn from a
seed.

Counterpart of ``repro.models.model.build_model``. The reference returns a
bundle of pure functions over a parameter tree; the port returns the
module whose methods are those functions: an
:class:`~repro_torch.models.encdec.EncDec` for the ``encdec`` family, a
:class:`~repro_torch.models.transformer.Transformer` for every other.
"""

from __future__ import annotations

import torch

from .config import ModelConfig
from .encdec import EncDec
from .transformer import Transformer


def build_model(cfg: ModelConfig, device=None, seed: int | None = 0,
                trainable: bool = False) -> Transformer | EncDec:
    """The model of ``cfg`` on ``device`` (``None``: CUDA), parameters
    initialised from a ``torch.Generator`` seeded with ``seed`` on that
    device. ``seed=None`` leaves them uninitialised, for a caller that
    fills them (``repro_torch.convert.model_params_from_jax``).
    ``trainable`` makes every parameter require grad, for
    ``train_forward``; the serving paths run under ``torch.no_grad``
    either way."""
    cls = EncDec if cfg.family == "encdec" else Transformer
    model = cls(cfg, device=device)
    model.requires_grad_(trainable)
    if seed is not None:
        gen = torch.Generator(device=model.device).manual_seed(seed)
        model.init_params(gen)
    return model
