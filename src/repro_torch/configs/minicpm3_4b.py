"""MiniCPM3 4B — dense with Multi-head Latent Attention
[hf:openbmb/MiniCPM3-4B]: q_lora 768, kv_lora 256, 40 heads; q and k 96
wide (64 without RoPE, 32 with), v 64.

Port of ``repro.configs.minicpm3_4b``: ``CONFIG`` and ``SMOKE`` verbatim.
The mixer is :mod:`repro_torch.nn.mla`."""
from .base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense", source="hf:openbmb/MiniCPM3-4B",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=6400,
    vocab_size=73448, use_mla=True,
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                  qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
)

SMOKE = ModelConfig(
    name="minicpm3-smoke", family="dense", source="reduced",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
    vocab_size=512, use_mla=True,
    mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                  qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32),
)
