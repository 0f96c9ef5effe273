"""DeepSeek-V3 671B — MLA + 1 shared + 256 routed top-8 experts + MTP
[arXiv:2412.19437]. First 3 layers dense (d_ff 18432); MoE layers use
2048-wide experts with sigmoid routing; one Multi-Token Prediction block
at train time.

Port of ``repro.configs.deepseek_v3_671b``: ``CONFIG`` and ``SMOKE``
verbatim. The mixer is :mod:`repro_torch.nn.mla` (q/k 192 = 128 + 64
RoPE, v 128), the feed-forward :mod:`repro_torch.nn.moe`, the MTP branch
``models.transformer.lm_loss``'s."""
from .base import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe", source="arXiv:2412.19437",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_ff=18432,
    vocab_size=129280, use_mla=True, use_mtp=True,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, n_experts_per_tok=8, n_shared_experts=1,
                  d_ff_expert=2048, first_dense_layers=3,
                  router_scoring="sigmoid"),
)

SMOKE = ModelConfig(
    name="deepseek-smoke", family="moe", source="reduced",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
    vocab_size=512, use_mla=True, use_mtp=True,
    mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                  qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32),
    moe=MoEConfig(n_experts=4, n_experts_per_tok=2, n_shared_experts=1,
                  d_ff_expert=128, first_dense_layers=1,
                  router_scoring="sigmoid", capacity_factor=4.0),
)
