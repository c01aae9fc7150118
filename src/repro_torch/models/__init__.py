"""Model code of the port: config schema, layers, attention, the dense
decoder-only transformer and ``build_model``."""

from .config import ModelConfig
from .model import build_model
from .transformer import Transformer

__all__ = ["ModelConfig", "Transformer", "build_model"]
