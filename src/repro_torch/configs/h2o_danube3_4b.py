"""h2o-danube-3-4b — llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; unverified]. The dims of ``repro.configs.h2o_danube3_4b``,
copied: 24 layers, d 3840, 32 query heads over 8 KV heads of 120 (not
128), SwiGLU of 10,240, vocab 32,000, a sliding window of 4,096 tokens
kept as a rolling buffer, so the decode state is O(window).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, d_ff=10240,
    vocab_size=32000, sliding_window=4096, rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="h2o-danube-3-4b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, sliding_window=8, dtype="float32",
)
