"""xlstm-350m — sLSTM + mLSTM blocks, 7:1 ratio. [arXiv:2405.04517;
unverified].

The dims of ``repro.configs.xlstm_350m``, copied: 24 layers in 3 groups
of 8 (sLSTM at offset 4 of each, mLSTM elsewhere), d 1024, 4 heads, no
separate feed-forward (the mLSTM block carries its own 2x up / down
projection), block-diagonal per-head q / k / v, tied embeddings. The
state is recurrent and O(1): no layer holds a KV cache.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab_size=50304, rope_type="none", tie_embeddings=True,
    slstm_every=8, slstm_offset=4, xlstm_proj_factor=2.0, xlstm_conv=4,
)

SMOKE = ModelConfig(
    name="xlstm-350m-smoke", family="ssm",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab_size=512, rope_type="none", tie_embeddings=True,
    slstm_every=8, slstm_offset=4, dtype="float32",
)
