"""Qwen3 0.6B — dense GQA with per-head qk RMSNorm [hf:Qwen/Qwen3-8B
family card]. head_dim fixed at 128 (> d_model/n_heads).

Port of ``repro.configs.qwen3_0_6b``: ``CONFIG`` and ``SMOKE`` verbatim."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense", source="hf:Qwen/Qwen3-8B",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=3072, vocab_size=151936, qk_norm=True, rope_theta=1e6,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen3-smoke", family="dense", source="reduced",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
    d_ff=512, vocab_size=512, qk_norm=True, rope_theta=1e6,
    tie_embeddings=True,
)
