"""Whisper base — encoder-decoder audio backbone [arXiv:2212.04356]. The
mel-spectrogram and conv frontend is a stub, as in the reference: the
encoder takes (B, 1,500, d_model) frame embeddings. Six encoder and six
decoder layers of d 512, 8 heads of 64, LayerNorm, gated tanh-GELU MLP,
untied head: ~0.11 B parameters as the reference builds it.

Port of ``repro.configs.whisper_base``: ``CONFIG`` and ``SMOKE``
verbatim."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio", source="arXiv:2212.04356",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
    vocab_size=51865, norm="layernorm", activation="gelu",
    is_encoder_decoder=True, n_encoder_layers=6, n_audio_frames=1500,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio", source="reduced",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
    vocab_size=512, norm="layernorm", activation="gelu",
    is_encoder_decoder=True, n_encoder_layers=2, n_audio_frames=64,
)
