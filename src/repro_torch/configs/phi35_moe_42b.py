"""phi3.5-moe-42b-a6.6b — 16 experts, top-2, MoE on every layer.

[hf:microsoft/Phi-3.5-MoE-instruct; hf]. The dims of
``repro.configs.phi35_moe_42b``, copied: 32 layers, each attention (32
query heads over 8 KV heads of 128) and a MoE of 16 experts of 3 x 4096 x
6400, top-2; 40.3 B routed parameters and about 1.6 B of attention and
embeddings, so about 42 B in all, 6.6 B active a token.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=6400,
    vocab_size=32064,
    moe_every=1, moe_offset=0, n_experts=16, top_k=2,
)

SMOKE = ModelConfig(
    name="phi3.5-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512,
    moe_every=1, moe_offset=0, n_experts=4, top_k=2, capacity_factor=2.0,
    dtype="float32",
)
