"""Chameleon 34B — early-fusion VLM [arXiv:2405.09818]. Image VQ tokens
share the text vocabulary; the vision tokenizer is a stub, as in the
reference, so the model takes mixed-modal token ids directly. qk-norm per
the paper's stability fix; GQA 64:8 at head dim 128.

Port of ``repro.configs.chameleon_34b``: ``CONFIG`` and ``SMOKE``
verbatim."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm", source="arXiv:2405.09818",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016,
    vocab_size=65536, qk_norm=True, rope_theta=10000.0,
    is_early_fusion_vlm=True,
)

SMOKE = ModelConfig(
    name="chameleon-smoke", family="vlm", source="reduced",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
    vocab_size=512, qk_norm=True, is_early_fusion_vlm=True,
)
