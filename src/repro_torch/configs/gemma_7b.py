"""Gemma 7B — dense, GeGLU, head_dim=256 [arXiv:2403.08295]: 16 heads of
256 (q 4,096 wide over d 3,072), no GQA, tied embeddings, vocab 256,000.

Port of ``repro.configs.gemma_7b``: ``CONFIG`` and ``SMOKE`` verbatim. The
port follows the reference, not Hugging Face's Gemma: the reference
scales no embedding by sqrt(d_model) and its RMSNorm multiplies by the
scale itself (not by 1 + scale), so the port does the same."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense", source="arXiv:2403.08295",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab_size=256000, activation="gelu",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma-smoke", family="dense", source="reduced",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
    d_ff=512, vocab_size=512, activation="gelu", tie_embeddings=True,
)
