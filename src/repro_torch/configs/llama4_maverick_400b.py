"""llama4-maverick-400b-a17b — MoE 128e top-1, interleaved dense/MoE.

[hf:meta-llama/Llama-4-*; unverified]. The dims of
``repro.configs.llama4_maverick_400b``, copied: 48 layers, d 5120, 40
query heads over 8 KV heads of 128, vocab 202,048; a dense MLP of 8192 at
even layers and, at odd ones, a MoE of 128 experts of 3 x 5120 x 8192 with
top-1 routing and one shared expert. 24 MoE layers x 128 experts x 3 x
5120 x 8192 = 386 B routed parameters and about 11 B more, so about 397 B
in all, 17.6 B active a token.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab_size=202048, rope_theta=500_000.0,
    moe_every=2, moe_offset=1, n_experts=128, top_k=1, n_shared_experts=1,
)

SMOKE = ModelConfig(
    name="llama4-maverick-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, rope_theta=500_000.0,
    moe_every=2, moe_offset=1, n_experts=4, top_k=1, n_shared_experts=1,
    capacity_factor=2.0, dtype="float32",
)
