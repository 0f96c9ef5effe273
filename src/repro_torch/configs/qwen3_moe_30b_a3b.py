"""Qwen3-MoE 30B-A3B — 128 experts top-8, every layer MoE, GQA kv=4,
qk-norm [hf:Qwen/Qwen3-30B-A3B]. 768-wide experts (the assignment's
d_ff); no shared expert.

Port of ``repro.configs.qwen3_moe_30b_a3b``: ``CONFIG`` and ``SMOKE``
verbatim."""
from .base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe", source="hf:Qwen/Qwen3-30B-A3B",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab_size=151936, qk_norm=True, rope_theta=1e6,
    moe=MoEConfig(n_experts=128, n_experts_per_tok=8, d_ff_expert=768),
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke", family="moe", source="reduced",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
    d_ff=256, vocab_size=512, qk_norm=True,
    moe=MoEConfig(n_experts=4, n_experts_per_tok=2, d_ff_expert=256,
                  capacity_factor=4.0),
)
