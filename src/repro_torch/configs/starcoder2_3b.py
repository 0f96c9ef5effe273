"""StarCoder2 3B — dense GQA kv=2, RoPE, 4k sliding window
[arXiv:2402.19173]. LayerNorm and tanh GELU; the reference substitutes a
gated MLP for the original's plain one, and the port follows it. 24 query
heads share 2 KV heads (12:1).

Port of ``repro.configs.starcoder2_3b``: ``CONFIG`` and ``SMOKE``
verbatim."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", family="dense", source="arXiv:2402.19173",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, d_ff=12288,
    vocab_size=49152, norm="layernorm", activation="gelu",
    sliding_window=4096, rope_theta=1e5,
)

SMOKE = ModelConfig(
    name="starcoder2-smoke", family="dense", source="reduced",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
    vocab_size=512, norm="layernorm", activation="gelu",
    sliding_window=128, rope_theta=1e5,
)
