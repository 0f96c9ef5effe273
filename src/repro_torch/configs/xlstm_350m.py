"""xLSTM 350M — mLSTM stack with interleaved sLSTM blocks
[arXiv:2405.04517]. Attention-free: layer i is sLSTM when (i + 1) % 6 ==
0, mLSTM otherwise, and no block has a feed-forward.

Port of ``repro.configs.xlstm_350m``: ``CONFIG`` and ``SMOKE`` verbatim."""
from .base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm", source="arXiv:2405.04517",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab_size=50304, norm="layernorm",
    xlstm=XLSTMConfig(slstm_every=6, conv_dim=4, proj_factor=2.0),
)

SMOKE = ModelConfig(
    name="xlstm-smoke", family="ssm", source="reduced",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab_size=512, norm="layernorm",
    xlstm=XLSTMConfig(slstm_every=2, conv_dim=4, proj_factor=2.0),
)
