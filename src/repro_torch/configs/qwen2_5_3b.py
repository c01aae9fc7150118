"""qwen2.5-3b — dense GQA (kv=2), QKV bias, tied embeddings. [hf:Qwen; hf].

The dims of ``repro.configs.qwen2_5_3b``, copied.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, d_ff=11008,
    vocab_size=151936, qkv_bias=True, rope_theta=1_000_000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen2.5-3b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, qkv_bias=True, tie_embeddings=True, dtype="float32",
)
