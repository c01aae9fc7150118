"""qwen2-vl-72b — 80L d8192 64H (GQA kv=8) ff29568 vocab152064, M-RoPE.

[arXiv:2409.12191; hf]. The dims of ``repro.configs.qwen2_vl_72b``,
copied. The vision frontend is a stub, as there: ``prefill`` takes
precomputed patch / text embeddings and (t, h, w) position ids; the trunk
applies M-RoPE (three rotary sections of 16 / 24 / 24 over head_dim / 2 =
64).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab_size=152064, qkv_bias=True,
    rope_type="mrope", rope_theta=1_000_000.0, mrope_sections=(16, 24, 24),
)

SMOKE = ModelConfig(
    name="qwen2-vl-72b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, qkv_bias=True,
    rope_type="mrope", rope_theta=1_000_000.0, mrope_sections=(4, 2, 2),
    dtype="float32",
)
