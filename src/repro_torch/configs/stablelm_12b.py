"""stablelm-12b — dense, LayerNorm trunk. [hf:stabilityai; hf].

The dims of ``repro.configs.stablelm_12b``, copied: 40 layers, d 5120, 32
query heads over 8 KV heads of 160, SwiGLU of 13,824, vocab 100,352,
LayerNorm. As the reference: full rotary and no per-head qk-norm (the
published model has both 25 % partial rotary and qk-norm).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=13824,
    vocab_size=100352, norm="layernorm",
)

SMOKE = ModelConfig(
    name="stablelm-12b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, norm="layernorm", dtype="float32",
)
