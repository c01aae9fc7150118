"""qwen2-72b — dense GQA with QKV bias. [arXiv:2407.10671; hf].

The dims of ``repro.configs.qwen2_72b``, copied: 80 layers, d 8192, 64
query heads over 8 KV heads of 128, SwiGLU of 29,568, vocab 152,064,
untied head; about 72.7 B parameters.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab_size=152064, qkv_bias=True, rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen2-72b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, qkv_bias=True, rope_theta=1_000_000.0, dtype="float32",
)
