"""Jamba v0.1 52B — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887]. Attention every 8th layer; MoE replaces the MLP on
every other layer (period 2, offset 1).

Port of ``repro.configs.jamba_v0_1_52b``: ``CONFIG`` and ``SMOKE``
verbatim. The full 32 layers (51.6 B parameters, 192 GiB in float32) need
more than one card; one 8-layer period fits an 80 GB H100."""
from .base import MoEConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid", source="arXiv:2403.19887",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=65536, rope_theta=10000.0,
    attn_layer_period=8, attn_layer_offset=4,
    moe=MoEConfig(n_experts=16, n_experts_per_tok=2, d_ff_expert=14336,
                  layer_period=2, layer_offset=1),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    # long_500k: attention layers drop to a sliding window (Mamba layers are
    # already O(T)); window set by the serve path for that shape only.
)

SMOKE = ModelConfig(
    name="jamba-smoke", family="hybrid", source="reduced",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
    vocab_size=512, attn_layer_period=2, attn_layer_offset=1,
    moe=MoEConfig(n_experts=4, n_experts_per_tok=2, d_ff_expert=512,
                  layer_period=2, layer_offset=0, capacity_factor=4.0),
    ssm=SSMConfig(d_state=8, d_conv=4, expand=2),
)
