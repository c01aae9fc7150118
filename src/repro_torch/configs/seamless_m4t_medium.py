"""seamless-m4t-medium — encoder-decoder, audio frontend stubbed.

[arXiv:2308.11596; hf]. The dims of ``repro.configs.seamless_m4t_medium``,
copied: 12 encoder and 12 decoder layers, d 1024, 16 heads of 64 (MHA),
d_ff 4,096, LayerNorm, GELU, vocab 256,206 padded by 50 rows to 256,256.
The speech frontend is a stub: the encoder takes precomputed frame
embeddings ``[B, S, d_model]``. As the reference: rotary in place of the
relative position bias, and a gated (GeGLU) feed-forward.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, n_enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=256206, vocab_pad=50,   # 256256 = 16-divisible TP
    norm="layernorm", act="gelu",
)

SMOKE = ModelConfig(
    name="seamless-m4t-smoke", family="encdec",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=512, norm="layernorm", act="gelu", dtype="float32",
)
