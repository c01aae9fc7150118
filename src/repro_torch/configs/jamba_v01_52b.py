"""jamba-v0.1-52b — hybrid Mamba+attention 1:7, MoE 16e top-2.

[arXiv:2403.19887; hf]. The dims of ``repro.configs.jamba_v01_52b``,
copied: 32 layers in 4 Jamba blocks of 8, attention at offset 4 of each
block and Mamba elsewhere, MoE in place of the MLP on every 2nd layer
(offset 1), no positional embeddings (``rope_type="none"``).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=65536, rope_type="none",
    attn_every=8, attn_offset=4,
    moe_every=2, moe_offset=1, n_experts=16, top_k=2,
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
)

SMOKE = ModelConfig(
    name="jamba-v0.1-52b-smoke", family="hybrid",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, rope_type="none",
    attn_every=8, attn_offset=4,
    moe_every=2, moe_offset=1, n_experts=4, top_k=2, capacity_factor=2.0,
    mamba_d_state=8, mamba_d_conv=4, mamba_expand=2,
    dtype="float32",
)
