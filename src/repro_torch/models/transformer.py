"""Decoder LM assembly: prefill and one-token decode of the dense
attention backbones.

Port of ``repro.models.transformer`` for blocks of self-attention and a
dense gated MLP (qwen3-0.6b's layout). The reference groups layers into
homogeneous segments, stacks each segment's parameters on a leading axis
and runs it under ``lax.scan``; the port keeps the segments but holds a
list of per-layer parameter dicts in each and runs a Python loop over
them. :mod:`repro_torch.convert` unstacks the reference's arrays.

Caches stay stacked per segment, (n_layers_in_segment, B, S, n_kv,
head_dim), as in the reference; a decode step writes each layer's slice
in place.

Other mixers (MLA, Mamba, xLSTM), MoE feed-forwards, the Whisper
encoder-decoder and the MTP head raise ``NotImplementedError``: ROADMAP.md
lists them. ``lm_loss`` comes with the training slice. The reference's
``hints.residual`` and ``hints.logits`` are identities off a mesh and are
left out, and so is ``window_override`` (only the reference's dry run sets
it): attention uses ``cfg.sliding_window``.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.nn.attention import (KVCache, attention, init_attention,
                                      init_cache, rope_cos_sin)
from repro_torch.nn.layers import apply_norm, embed_init, init_mlp, init_norm, mlp


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


def check_supported(cfg: ModelConfig) -> None:
    """Raise for any part of ``cfg`` the port does not run yet."""
    other = sorted({f"{m}/{f}" for m, f, _ in segment_plan(cfg)
                    if (m, f) != ("attn", "dense")})
    if other or cfg.is_encoder_decoder or cfg.use_mtp:
        what = ", ".join(other + ["encoder-decoder"] * cfg.is_encoder_decoder
                         + ["MTP"] * cfg.use_mtp)
        raise NotImplementedError(
            f"{cfg.name}: the port runs attention + dense-MLP blocks only, "
            f"not {what}; ROADMAP.md lists the rest")


def _init_block(cfg, generator) -> dict:
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
    """Parameters in the reference's shapes and init scales, drawn on the
    CPU from ``generator`` and moved to ``device`` (cuda unless
    ``device="cpu"``): ``embed``, ``final_norm``, ``head`` (untied only)
    and ``segments``, a list (one per segment) of per-layer dicts. The
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
    params["segments"] = [[_init_block(cfg, generator) for _ in range(n)]
                          for _, _, n in segment_plan(cfg)]
    return _to(params, device)


# ----------------------------------------------------------------- blocks

def _apply_block(bp: dict, cfg, x, positions, *, cache=None,
                 cache_index=None, cos_sin=None):
    """Pre-norm residual block (attention, dense MLP) -> (x, cache)."""
    h = apply_norm(cfg.norm, bp["pre_norm"], x, cfg.norm_eps)
    mix, new_cache = attention(bp["mixer"], cfg, h, positions, cache=cache,
                               cache_index=cache_index, cos_sin=cos_sin)
    x = x + mix
    h = apply_norm(cfg.norm, bp["post_norm"], x, cfg.norm_eps)
    return x + mlp(bp["ffn"], h, cfg.activation), new_cache


# ---------------------------------------------------------------- forward

class LMOut(NamedTuple):
    """The reference's LMOut without ``aux_loss``: no block of the port
    has a MoE router."""
    logits: torch.Tensor
    hidden: torch.Tensor


def _run_segments(params, cfg, x, positions, *, caches=None,
                  cache_index=None):
    """Every layer in order; ``caches`` (per-segment stacked) are updated
    in place. The RoPE angles are computed once for all layers."""
    cos_sin = rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)
    for si, layers in enumerate(params["segments"]):
        for j, bp in enumerate(layers):
            lc = None if caches is None else KVCache(caches[si].k[j],
                                                     caches[si].v[j])
            x, _ = _apply_block(bp, cfg, x, positions, cache=lc,
                                cache_index=cache_index, cos_sin=cos_sin)
    return x


def _lm_head(params, cfg, hidden):
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    logits = hidden @ w
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _embed(params, cfg, tokens):
    return params["embed"][tokens].to(getattr(torch, cfg.dtype))


def hidden_states(params, cfg: ModelConfig, tokens) -> torch.Tensor:
    """Teacher-forced pass to the final norm: (B, T) -> (B, T, d)."""
    B, T = tokens.shape
    x = _embed(params, cfg, tokens)
    positions = torch.arange(T, device=tokens.device)[None].expand(B, T)
    x = _run_segments(params, cfg, x, positions)
    return apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)


def forward(params, cfg: ModelConfig, tokens) -> LMOut:
    """Teacher-forced forward. tokens: (B, T) int -> logits (B, T, V)."""
    hidden = hidden_states(params, cfg, tokens)
    return LMOut(logits=_lm_head(params, cfg, hidden), hidden=hidden)


def prefill(params, cfg: ModelConfig, tokens) -> LMOut:
    """Prefill = the teacher-forced forward (inference)."""
    return forward(params, cfg, tokens)


# ----------------------------------------------------------------- decode

def init_caches(cfg: ModelConfig, batch: int, seq_len: int, *, device=None,
                dtype=None) -> List[KVCache]:
    """Per-segment stacked caches for decode, zeros, on ``device`` (cuda
    unless ``device="cpu"``)."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.dtype)
    caches = []
    for _, _, n in segment_plan(cfg):
        one = init_cache(cfg, batch, seq_len, device=device, dtype=dtype)
        caches.append(KVCache(k=one.k.new_zeros((n,) + one.k.shape),
                              v=one.v.new_zeros((n,) + one.v.shape)))
    return caches


def decode_step(params, cfg: ModelConfig, token, caches, index):
    """One-token decode. token: (B, 1) int; index: the position (int).

    Returns (logits (B, 1, V), caches), the caches updated in place."""
    B = token.shape[0]
    index = int(index)
    x = _embed(params, cfg, token)
    positions = torch.full((B, 1), index, dtype=torch.int64,
                           device=token.device)
    x = _run_segments(params, cfg, x, positions, caches=caches,
                      cache_index=index)
    hidden = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    return _lm_head(params, cfg, hidden), caches
