"""Model / run configuration dataclasses.

Port of ``repro.configs.base``, copied: the file imports only
``dataclasses`` and ``typing``, and the port keeps its own copy so that it
imports nothing of the reference package. Every assigned architecture is
a ``ModelConfig``, a plain frozen dataclass.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts sub-config (GShard/DeepSeek-style routed experts)."""
    n_experts: int = 0                 # routed experts
    n_experts_per_tok: int = 0         # top-k
    n_shared_experts: int = 0          # DeepSeek shared experts (always-on)
    d_ff_expert: int = 0               # per-expert hidden size
    layer_period: int = 1              # every `period`-th layer is MoE ...
    layer_offset: int = 0              # ... starting at this index
    first_dense_layers: int = 0        # DeepSeek-V3: first k layers stay dense
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    router_dtype: str = "float32"
    router_scoring: str = "softmax"    # softmax | sigmoid (DeepSeek-V3)
    dispatch: str = "shardmap"         # shardmap (local EP + one psum) |
                                       # flat (E*C buffer, SPMD-partitioned)
                                       # | bucketed (refuted, kept for
                                       #   comparison — see §Perf)

    @property
    def enabled(self) -> bool:
        return self.n_experts > 0


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2/V3, MiniCPM3)."""
    q_lora_rank: int = 0               # 0 = full-rank q projection
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-style selective SSM sub-config (Jamba mixer layers)."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                   # 0 -> ceil(d_model/16)


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block layout: sLSTM layers interleaved into an mLSTM stack."""
    slstm_every: int = 6               # layer i is sLSTM when (i+1) % every == 0
    conv_dim: int = 4                  # causal-conv width in mLSTM blocks
    proj_factor: float = 2.0           # up-projection factor in mLSTM
    slstm_proj_factor: float = 1.333   # ffn factor of sLSTM post-block


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"              # dense|moe|hybrid|ssm|vlm|audio
    source: str = ""                   # citation for the config numbers

    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0                  # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    max_seq_len: int = 8192

    norm: str = "rmsnorm"              # rmsnorm|layernorm
    norm_eps: float = 1e-6
    activation: str = "silu"           # silu (swiglu) | gelu (geglu)
    qk_norm: bool = False              # Qwen3-style per-head q/k RMSNorm
    rope_theta: float = 10000.0
    sliding_window: int = 0            # 0 = full attention
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    attn_layer_period: int = 1         # hybrid: every k-th layer is attention
    attn_layer_offset: int = 0
    mixer: str = "attention"           # attention|mamba|mlstm (default mixer)

    use_mla: bool = False
    mla: MLAConfig = field(default_factory=MLAConfig)
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    xlstm: XLSTMConfig = field(default_factory=XLSTMConfig)

    # multi-token prediction (DeepSeek-V3): one extra MTP transformer layer
    use_mtp: bool = False
    mtp_loss_weight: float = 0.3

    # encoder-decoder (Whisper backbone). Frontend (mel+conv) is a STUB: the
    # model consumes precomputed frame embeddings of shape (B, n_frames, d).
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    n_audio_frames: int = 1500

    # vlm (Chameleon): early fusion — image VQ tokens share the text vocab.
    # The vision tokenizer is a STUB; input_specs feeds token ids directly.
    is_early_fusion_vlm: bool = False

    dtype: str = "float32"             # compute dtype
    param_dtype: str = "float32"

    # ---- derived ----
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def layer_kinds(self) -> Tuple[Tuple[str, str], ...]:
        """(mixer_kind, ffn_kind) per layer.

        mixer_kind in {attn, mla, mamba, mlstm, slstm}
        ffn_kind   in {dense, moe, none}
        """
        kinds = []
        for i in range(self.n_layers):
            if self.family == "ssm":
                x = self.xlstm
                mixer = "slstm" if (i + 1) % x.slstm_every == 0 else "mlstm"
                ffn = "none"
            elif self.family == "hybrid":
                is_attn = (i % self.attn_layer_period) == self.attn_layer_offset
                mixer = "attn" if is_attn else "mamba"
                ffn = "dense"
            elif self.use_mla:
                mixer, ffn = "mla", "dense"
            else:
                mixer, ffn = "attn", "dense"
            if self.moe.enabled and ffn == "dense":
                m = self.moe
                if i >= m.first_dense_layers and (i % m.layer_period) == m.layer_offset:
                    ffn = "moe"
            kinds.append((mixer, ffn))
        return tuple(kinds)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, hd = self.d_model, self.resolved_head_dim
        nq, nkv = self.n_heads, self.n_kv_heads
        total = self.vocab_size * d                      # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d                 # lm head
        for mixer, ffn in self.layer_kinds():
            if mixer == "attn":
                total += d * nq * hd + 2 * d * nkv * hd + nq * hd * d
            elif mixer == "mla":
                m = self.mla
                qin = m.q_lora_rank if m.q_lora_rank else d
                if m.q_lora_rank:
                    total += d * m.q_lora_rank
                total += qin * nq * m.qk_head_dim
                total += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                total += m.kv_lora_rank * nq * (m.qk_nope_head_dim + m.v_head_dim)
                total += nq * m.v_head_dim * d
            elif mixer == "mamba":
                s = self.ssm
                di = s.expand * d
                dt = s.dt_rank if s.dt_rank else -(-d // 16)
                total += d * 2 * di + di * s.d_conv + di * (dt + 2 * s.d_state)
                total += dt * di + di * s.d_state + di + di * d
            elif mixer == "mlstm":
                x = self.xlstm
                di = int(x.proj_factor * d)
                total += 2 * d * di + di * x.conv_dim + 3 * di * di // 4 + di * d
            elif mixer == "slstm":
                total += 4 * d * d + int(2 * self.xlstm.slstm_proj_factor * d * d)
            if ffn == "dense":
                total += 3 * d * self.d_ff
            elif ffn == "moe":
                m = self.moe
                total += d * m.n_experts                                   # router
                total += m.n_experts * 3 * d * m.d_ff_expert               # routed
                total += m.n_shared_experts * 3 * d * m.d_ff_expert        # shared
            total += 2 * d                                                  # norms
        if self.is_encoder_decoder:
            for _ in range(self.n_encoder_layers):
                total += 4 * d * nq * hd + 3 * d * self.d_ff + 2 * d       # enc self+ffn
            for _ in range(self.n_layers):
                total += 2 * d * nq * hd + 2 * d * nkv * hd + d            # cross attn
        if self.use_mtp:
            total += d * nq * hd + 2 * d * nkv * hd + nq * hd * d + 3 * d * self.d_ff
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k + shared experts)."""
        if not self.moe.enabled:
            return self.param_count()
        m = self.moe
        inactive_per_moe_layer = (m.n_experts - m.n_experts_per_tok) * 3 * self.d_model * m.d_ff_expert
        n_moe_layers = sum(1 for _, f in self.layer_kinds() if f == "moe")
        return self.param_count() - n_moe_layers * inactive_per_moe_layer

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape."""
    name: str
    seq_len: int
    global_batch: int
    mode: str                          # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    seed: int = 0
    remat: bool = True
