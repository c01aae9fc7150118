"""Model code of the port: config schema, layers, attention, the
decoder-only transformer (dense, MoE, hybrid, xLSTM), the encoder-decoder
and ``build_model``."""

from .config import ModelConfig
from .encdec import EncDec
from .model import build_model
from .transformer import Transformer

__all__ = ["EncDec", "ModelConfig", "Transformer", "build_model"]
