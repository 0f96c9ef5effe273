"""Decoder LM assembly: the training loss, prefill and one-token decode.

Port of ``repro.models.transformer`` for blocks of self-attention,
Multi-head Latent Attention (:mod:`repro_torch.nn.mla`), a Mamba mixer or
an xLSTM mixer (mLSTM, sLSTM), each with a dense gated MLP, a MoE
feed-forward or none (the xLSTM blocks): qwen3-0.6b, starcoder2-3b,
gemma-7b, minicpm3-4b (MLA), deepseek-v3 (MLA, sigmoid-routed MoE with a
shared expert, and the MTP head), the jamba hybrid, xlstm-350m,
qwen3-moe-30b-a3b and chameleon-34b (early fusion: its image tokens share
the text vocabulary, so it is a plain decoder). whisper-base adds the
encoder-decoder parts: a non-causal encoder over stub frame embeddings
(:func:`encode_audio`, RoPE on its q and k as the reference applies it)
and, in every decoder block, a cross-attention to the encoder's output
under its own norm (``enc_out=`` of the forward, prefill, decode and
loss). The reference groups layers into homogeneous segments, stacks each
segment's parameters on a leading axis and runs it under ``lax.scan``;
the port keeps the segments but holds a list of per-layer parameter dicts
in each and runs a Python loop over them.
:mod:`repro_torch.convert` unstacks the reference's arrays.

Caches stay stacked per segment, as in the reference: a
:class:`KVCache` (n_layers_in_segment, B, S, n_kv, head_dim) for
attention, an :class:`MLACache` (c_kv (n, B, S, kv_lora_rank), k_rope
(n, B, S, qk_rope_head_dim)) for MLA, a :class:`MambaCache` (h (n, B,
di, N), conv (n, B, K - 1, di)) for Mamba and an :class:`MLSTMCache` or
:class:`SLSTMCache` for xLSTM; a decode step writes each layer's slice
in place.

A config with ``use_mtp`` (deepseek-v3's Multi-Token Prediction) has
``params["mtp"]``: ``proj`` (2d, d), one attention/dense ``block`` at
``resolved_head_dim`` (56 at deepseek-v3, which the flash kernel runs
padded to 64) and ``norm``. Only :func:`lm_loss` reads it, as in the
reference: its branch (:func:`mtp_hidden`) predicts token t + 2 from the
final hidden state at t and the embedding of token t + 1; the forward,
prefill and decode never run it. With
``remat`` each block runs under ``torch.utils.checkpoint``, as the
reference wraps each scanned block body in ``jax.checkpoint``: its
activations are recomputed in the backward, not kept (the MTP block is
not, as in the reference). ``hints.residual`` (after the embedding and
each block) and ``hints.logits`` (the head) lay the activations out on a
device mesh and are identities off one (:mod:`repro_torch.hints`); the
embedding is ``F.embedding``, which DTensor shards by vocab, the same
values as an index. The reference's ``window_override`` (its
``long_500k`` variant) is the mesh step builders' (a config with that
``sliding_window``); attention here uses ``cfg.sliding_window``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import hints, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.nn.attention import (attend, attention, cross_attention,
                                      init_attention, init_cache,
                                      init_cross_attention, rope_cos_sin,
                                      rotate)
from repro_torch.nn.layers import apply_norm, embed_init, init_mlp, init_norm, mlp
from repro_torch.nn.mla import init_mla, init_mla_cache, mla_attention
from repro_torch.nn.moe import init_moe, moe_apply
from repro_torch.nn.ssm import init_mamba, init_mamba_cache, mamba
from repro_torch.nn.xlstm import (init_mlstm, init_mlstm_cache, init_slstm,
                                  init_slstm_cache, mlstm, slstm)


# --------------------------------------------------------------- segments

def segment_plan(cfg: ModelConfig) -> Tuple[Tuple[str, str, int], ...]:
    """Maximal runs of identical (mixer, ffn) layer signatures."""
    runs = []
    for mixer, ffn in cfg.layer_kinds():
        if runs and runs[-1][0] == mixer and runs[-1][1] == ffn:
            runs[-1][2] += 1
        else:
            runs.append([mixer, ffn, 1])
    return tuple((m, f, n) for m, f, n in runs)


MIXERS = ("attn", "mla", "mamba", "mlstm", "slstm")
FFNS = ("dense", "moe", "none")
_INIT_MIXER = {"attn": init_attention, "mla": init_mla, "mamba": init_mamba,
               "mlstm": init_mlstm, "slstm": init_slstm}
#: mixers whose decode step writes its own cache slot in place
_OWN_SLOT = ("attn", "mla")
_RECURRENT = {"mamba": mamba, "mlstm": mlstm, "slstm": slstm}


def check_supported(cfg: ModelConfig) -> None:
    """Raise for any block of ``cfg`` the port does not run."""
    other = sorted({f"{m}/{f}" for m, f, _ in segment_plan(cfg)
                    if m not in MIXERS or f not in FFNS})
    if other:
        raise NotImplementedError(
            f"{cfg.name}: the port runs attention, MLA, Mamba or xLSTM "
            f"mixers with dense, MoE or no feed-forwards (and the Whisper "
            f"encoder-decoder), not {', '.join(other)}; ROADMAP.md lists "
            f"the rest")


def _init_block(cfg, mixer: str, ffn: str, generator) -> dict:
    """A block's parameters; a block with ffn "none" (xLSTM) has neither
    ``post_norm`` nor ``ffn``, as in the reference. An encoder-decoder's
    (decoder) block also has ``cross_norm`` and ``cross``."""
    p = {"pre_norm": init_norm(cfg.norm, cfg.d_model),
         "mixer": _INIT_MIXER[mixer](cfg, generator=generator)}
    if ffn != "none":
        p["post_norm"] = init_norm(cfg.norm, cfg.d_model)
        p["ffn"] = (init_mlp(cfg.d_model, cfg.d_ff, generator=generator)
                    if ffn == "dense" else init_moe(cfg, generator=generator))
    if cfg.is_encoder_decoder:
        p["cross_norm"] = init_norm(cfg.norm, cfg.d_model)
        p["cross"] = init_cross_attention(cfg, generator=generator)
    return p


def _init_encoder_block(cfg, generator) -> dict:
    """One layer of the Whisper encoder: pre_norm, self-attention,
    post_norm, dense MLP."""
    return {"pre_norm": init_norm(cfg.norm, cfg.d_model),
            "mixer": init_attention(cfg, generator=generator),
            "post_norm": init_norm(cfg.norm, cfg.d_model),
            "ffn": init_mlp(cfg.d_model, cfg.d_ff, generator=generator)}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def init_lm(generator: Optional[torch.Generator], cfg: ModelConfig, *,
            device=None) -> dict:
    """Parameters in the reference's shapes and init scales, drawn from
    ``generator`` on its own device and moved to ``device`` (cuda unless
    ``device="cpu"``): ``embed``, ``final_norm``, ``head`` (untied only)
    and ``segments``, a list (one per segment) of per-layer dicts; an
    encoder-decoder also has ``encoder``, a list of ``n_encoder_layers``
    per-layer dicts, and ``enc_final_norm``; a config with ``use_mtp``
    also has ``mtp`` (``proj``, ``block``, ``norm``). A
    generator on the card draws there: one period of Jamba is 13.3 B
    floats, seconds on the card and ~53 GB of host memory on the CPU. The
    draws differ from the reference's ``jax.random`` ones; weights shared
    with the reference come through :mod:`repro_torch.convert`."""
    check_supported(cfg)
    device = resolve_device(device)
    params: dict = {
        "embed": embed_init(cfg.vocab_size, cfg.d_model, generator=generator),
        "final_norm": init_norm(cfg.norm, cfg.d_model),
    }
    if not cfg.tie_embeddings:
        params["head"] = embed_init(cfg.vocab_size, cfg.d_model,
                                    generator=generator).T.contiguous()
    params["segments"] = []
    for mixer, ffn, n in segment_plan(cfg):
        # moved as drawn: a CPU generator holds one segment on the host
        params["segments"].append(_to(
            [_init_block(cfg, mixer, ffn, generator) for _ in range(n)],
            device))
    if cfg.is_encoder_decoder:
        params["encoder"] = _to([_init_encoder_block(cfg, generator)
                                 for _ in range(cfg.n_encoder_layers)],
                                device)
        params["enc_final_norm"] = init_norm(cfg.norm, cfg.d_model)
    if cfg.use_mtp:
        params["mtp"] = _to({
            "proj": embed_init(2 * cfg.d_model, cfg.d_model,
                               generator=generator),
            "block": _init_block(cfg, "attn", "dense", generator),
            "norm": init_norm(cfg.norm, cfg.d_model)}, device)
    return _to(params, device)


# ----------------------------------------------------------------- blocks

def _apply_block(bp: dict, cfg, mixer: str, ffn: str, x, positions, *,
                 cache=None, cache_index=None, cos_sin=None, enc_out=None):
    """Pre-norm residual block -> (x, cache, aux_loss); ``aux_loss`` is the
    MoE router's, 0 for a dense block or one without a feed-forward. With
    ``enc_out`` an encoder-decoder's block attends to it under
    ``cross_norm`` between its mixer and its feed-forward."""
    h = apply_norm(cfg.norm, bp["pre_norm"], x, cfg.norm_eps)
    if mixer == "attn":
        mix, new_cache = attention(bp["mixer"], cfg, h, positions,
                                   cache=cache, cache_index=cache_index,
                                   cos_sin=cos_sin)
    elif mixer == "mla":
        mix, new_cache = mla_attention(bp["mixer"], cfg, h, positions,
                                       cache=cache, cache_index=cache_index)
    else:
        mix, new_cache = _RECURRENT[mixer](bp["mixer"], cfg, h, cache=cache)
    x = x + mix
    if cfg.is_encoder_decoder and enc_out is not None:
        h = apply_norm(cfg.norm, bp["cross_norm"], x, cfg.norm_eps)
        x = x + cross_attention(bp["cross"], cfg, h, enc_out)
    zero = x.new_zeros((), dtype=torch.float32)
    if ffn == "none":
        return x, new_cache, zero
    h = apply_norm(cfg.norm, bp["post_norm"], x, cfg.norm_eps)
    if ffn == "dense":
        return x + mlp(bp["ffn"], h, cfg.activation), new_cache, zero
    out = moe_apply(bp["ffn"], cfg, h, activation=cfg.activation)
    return x + out.y, new_cache, out.aux_loss


# ---------------------------------------------------------------- forward

class LMOut(NamedTuple):
    logits: torch.Tensor
    aux_loss: torch.Tensor
    hidden: torch.Tensor


def _layer_cache(seg_cache, j: int):
    """Layer ``j``'s views of a segment's stacked cache."""
    return type(seg_cache)(*(t[j] for t in seg_cache))


def _run_segments(params, cfg, x, positions, *, caches=None,
                  cache_index=None, remat=False, enc_out=None):
    """Every layer in order -> (x, summed aux_loss). ``caches``
    (per-segment stacked) are updated in place: attention and MLA write
    their cache slot themselves, a recurrent layer's (Mamba, mLSTM, sLSTM)
    new state is copied into its slice. The RoPE angles are computed once
    for all layers, where a layer attends (MLA rotates at its own width
    and computes its own). ``remat`` (no caches) recomputes each
    block's activations in the backward. ``enc_out`` goes to every block's
    cross-attention."""
    plan = segment_plan(cfg)
    cos_sin = (rope_cos_sin(positions, cfg.resolved_head_dim,
                            cfg.rope_theta)
               if any(m == "attn" for m, _, _ in plan) else None)
    aux = x.new_zeros((), dtype=torch.float32)
    for si, (mixer, ffn, _) in enumerate(plan):
        for j, bp in enumerate(params["segments"][si]):
            if remat:
                # the model draws no random numbers: no RNG state to keep
                x, a = checkpoint(_remat_block, bp, cfg, mixer, ffn, x,
                                  positions, cos_sin, enc_out,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
                x = hints.residual(x)
                aux = aux + a
                continue
            lc = None if caches is None else _layer_cache(caches[si], j)
            x, nc, a = _apply_block(bp, cfg, mixer, ffn, x, positions,
                                    cache=lc, cache_index=cache_index,
                                    cos_sin=cos_sin, enc_out=enc_out)
            x = hints.residual(x)
            aux = aux + a
            if lc is not None and mixer not in _OWN_SLOT:
                for dst, src in zip(lc, nc):
                    dst.copy_(_like(src, dst))
    return x, aux


def _like(src, dst):
    """``src`` laid out as ``dst`` (a DTensor cache slice) for a copy."""
    if hints.is_dtensor(dst) and src.placements != dst.placements:
        return src.redistribute(dst.device_mesh, dst.placements)
    return src


def _remat_block(bp, cfg, mixer, ffn, x, positions, cos_sin, enc_out):
    x, _, a = _apply_block(bp, cfg, mixer, ffn, x, positions,
                           cos_sin=cos_sin, enc_out=enc_out)
    return x, a


def encode_audio(params, cfg: ModelConfig, frames: torch.Tensor
                 ) -> torch.Tensor:
    """The Whisper encoder over stub frame embeddings: (B, n_frames, d) ->
    (B, n_frames, d). Each layer: non-causal self-attention (RoPE on q and
    k, as the reference applies it; the flash kernel), then the dense MLP,
    each pre-norm residual; then ``enc_final_norm``."""
    if not cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name} has no encoder")
    x = frames
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    pos = torch.arange(T, device=x.device)[None].expand(B, T)
    cos_sin = rope_cos_sin(pos, hd, cfg.rope_theta)
    for bp in params["encoder"]:
        h = apply_norm(cfg.norm, bp["pre_norm"], x, cfg.norm_eps)
        mp = bp["mixer"]
        q = rotate((h @ mp["wq"]).reshape(B, T, cfg.n_heads, hd), cos_sin)
        k = rotate((h @ mp["wk"]).reshape(B, T, cfg.n_kv_heads, hd), cos_sin)
        v = (h @ mp["wv"]).reshape(B, T, cfg.n_kv_heads, hd)
        o = attend(q, k, v, causal=False)
        x = x + o.reshape(B, T, cfg.n_heads * hd) @ mp["wo"]
        h = apply_norm(cfg.norm, bp["post_norm"], x, cfg.norm_eps)
        x = x + mlp(bp["ffn"], h, cfg.activation)
    return apply_norm(cfg.norm, params["enc_final_norm"], x, cfg.norm_eps)


def _lm_head(params, cfg, hidden):
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    logits = hints.logits(hidden @ w)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _embed(params, cfg, tokens):
    return hints.settle(hints.residual(F.embedding(tokens, params["embed"])
                                       .to(getattr(torch, cfg.dtype))))


def _forward_hidden(params, cfg, tokens, *, remat=False, enc_out=None):
    B, T = tokens.shape
    x = _embed(params, cfg, tokens)
    positions = torch.arange(T, device=tokens.device)[None].expand(B, T)
    x, aux = _run_segments(params, cfg, x, positions, remat=remat,
                           enc_out=enc_out)
    return apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps), aux


def hidden_states(params, cfg: ModelConfig, tokens, *, enc_out=None
                  ) -> torch.Tensor:
    """Teacher-forced pass to the final norm: (B, T) -> (B, T, d)."""
    return _forward_hidden(params, cfg, tokens, enc_out=enc_out)[0]


def forward(params, cfg: ModelConfig, tokens, *, enc_out=None,
            remat: bool = False) -> LMOut:
    """Teacher-forced forward. tokens: (B, T) int -> logits (B, T, V) and
    the MoE layers' summed aux loss; ``enc_out`` (B, Tsrc, d) is an
    encoder-decoder's :func:`encode_audio` output."""
    hidden, aux = _forward_hidden(params, cfg, tokens, remat=remat,
                                  enc_out=enc_out)
    return LMOut(logits=_lm_head(params, cfg, hidden), aux_loss=aux,
                 hidden=hidden)


def _nll(params, cfg, hidden, targets):
    """Mean cross-entropy of the head's float32 logits on ``hidden`` (B,
    T', d) against ``targets`` (B, T')."""
    logits = _lm_head(params, cfg, hidden).float()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1).long())


def mtp_hidden(params, cfg: ModelConfig, hidden, tokens) -> torch.Tensor:
    """The MTP branch up to the head: the final-norm ``hidden`` (B, T, d)
    at positions 0 ... T - 3 beside the embeddings of tokens 1 ... T - 2,
    through ``mtp.proj``, one attention/dense block at positions 0 ... T -
    3 (its own RoPE angles) and ``mtp.norm`` -> (B, T - 2, d). Its block's
    aux loss (0: dense) is dropped, as in the reference."""
    mp = params["mtp"]
    h = hidden[:, :-2]
    nxt = _embed(params, cfg, tokens[:, 1:-1]).to(h.dtype)
    z = torch.cat([h, nxt], dim=-1) @ mp["proj"]
    B, T = z.shape[:2]
    pos = torch.arange(T, device=z.device)[None].expand(B, T)
    z = _apply_block(mp["block"], cfg, "attn", "dense", z, pos)[0]
    return apply_norm(cfg.norm, mp["norm"], z, cfg.norm_eps)


def lm_loss(params, cfg: ModelConfig, tokens, *, enc_out=None,
            remat: bool = True) -> torch.Tensor:
    """Next-token cross-entropy over the (B, T - 1) targets, in float32,
    plus the MoE aux loss; with ``cfg.use_mtp`` also ``mtp_loss_weight``
    times the MTP branch's cross-entropy against tokens 2 ... T - 1
    (:func:`mtp_hidden`, the shared head), as the reference's ``lm_loss``.
    The head runs on the first T - 1 positions only, which gives the same
    logits as the reference's slice of the full (B, T, V) array without
    making it."""
    hidden, aux = _forward_hidden(params, cfg, tokens, remat=remat,
                                  enc_out=enc_out)
    loss = _nll(params, cfg, hidden[:, :-1], tokens[:, 1:]) + aux
    if cfg.use_mtp:
        loss = loss + cfg.mtp_loss_weight * _nll(
            params, cfg, mtp_hidden(params, cfg, hidden, tokens),
            tokens[:, 2:])
    return loss


def prefill(params, cfg: ModelConfig, tokens, *, enc_out=None) -> LMOut:
    """Prefill = the teacher-forced forward (inference)."""
    return forward(params, cfg, tokens, enc_out=enc_out)


# ----------------------------------------------------------------- decode

def init_caches(cfg: ModelConfig, batch: int, seq_len: int, *, device=None,
                dtype=None) -> list:
    """Per-segment stacked caches for decode on ``device`` (cuda unless
    ``device="cpu"``), each layer's slice its mixer's empty cache: a
    KVCache of ``seq_len`` positions for an attention segment, an MLACache
    of ``seq_len`` positions for an MLA one, a MambaCache for a Mamba one,
    an MLSTMCache or SLSTMCache (zeros, the stabiliser m at -1e30) for an
    xLSTM one."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.dtype)
    caches = []
    for mixer, _, n in segment_plan(cfg):
        if mixer == "attn":
            one = init_cache(cfg, batch, seq_len, device=device, dtype=dtype)
        elif mixer == "mla":
            one = init_mla_cache(cfg, batch, seq_len, device=device,
                                 dtype=dtype)
        elif mixer == "mamba":
            one = init_mamba_cache(cfg, batch, device=device, dtype=dtype)
        elif mixer == "mlstm":
            one = init_mlstm_cache(cfg, batch, device=device, dtype=dtype)
        else:
            one = init_slstm_cache(cfg, batch, device=device)
        caches.append(type(one)(*(t.expand((n,) + t.shape).contiguous()
                                  for t in one)))
    return caches


def decode_step(params, cfg: ModelConfig, token, caches, index, *,
                enc_out=None):
    """One-token decode. token: (B, 1) int; index: the position (int);
    ``enc_out`` an encoder-decoder's encoder output, whose k and v every
    step recomputes (no cross-KV cache, as in the reference).

    Returns (logits (B, 1, V), caches), the caches updated in place."""
    B = token.shape[0]
    index = int(index)
    x = _embed(params, cfg, token)
    positions = torch.full((B, 1), index, dtype=torch.int64,
                           device=token.device)
    x, _ = _run_segments(params, cfg, x, positions, caches=caches,
                         cache_index=index, enc_out=enc_out)
    hidden = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    return _lm_head(params, cfg, hidden), caches
