"""Decoder LM assembly: the training loss, prefill and one-token decode.

Port of ``repro.models.transformer`` for blocks of self-attention or a
Mamba mixer, each with a dense gated MLP or a MoE feed-forward: qwen3-0.6b
and the jamba hybrid. The reference groups layers into homogeneous
segments, stacks each segment's parameters on a leading axis and runs it
under ``lax.scan``; the port keeps the segments but holds a list of
per-layer parameter dicts in each and runs a Python loop over them.
:mod:`repro_torch.convert` unstacks the reference's arrays.

Caches stay stacked per segment, as in the reference: a
:class:`KVCache` (n_layers_in_segment, B, S, n_kv, head_dim) for
attention and a :class:`MambaCache` (h (n, B, di, N), conv (n, B, K - 1,
di)) for Mamba; a decode step writes each layer's slice in place.

Other mixers (MLA, xLSTM), the Whisper encoder-decoder and the MTP head
raise ``NotImplementedError``: ROADMAP.md lists them. With ``remat`` each
block runs under ``torch.utils.checkpoint``, as the reference wraps each
scanned block body in ``jax.checkpoint``: its activations are recomputed
in the backward, not kept. The reference's ``hints.residual`` and
``hints.logits`` are identities off a mesh and are left out, and so is
``window_override`` (only the reference's dry run sets it): attention uses
``cfg.sliding_window``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.nn.attention import (attention, init_attention, init_cache,
                                      rope_cos_sin)
from repro_torch.nn.layers import apply_norm, embed_init, init_mlp, init_norm, mlp
from repro_torch.nn.moe import init_moe, moe_apply
from repro_torch.nn.ssm import init_mamba, init_mamba_cache, mamba


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


MIXERS = ("attn", "mamba")
FFNS = ("dense", "moe")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for any part of ``cfg`` the port does not run yet."""
    other = sorted({f"{m}/{f}" for m, f, _ in segment_plan(cfg)
                    if m not in MIXERS or f not in FFNS})
    if other or cfg.is_encoder_decoder or cfg.use_mtp:
        what = ", ".join(other + ["encoder-decoder"] * cfg.is_encoder_decoder
                         + ["MTP"] * cfg.use_mtp)
        raise NotImplementedError(
            f"{cfg.name}: the port runs attention or Mamba mixers with dense "
            f"or MoE feed-forwards, not {what}; ROADMAP.md lists the rest")


def _init_block(cfg, mixer: str, ffn: str, generator) -> dict:
    return {"pre_norm": init_norm(cfg.norm, cfg.d_model),
            "mixer": (init_attention(cfg, generator=generator)
                      if mixer == "attn"
                      else init_mamba(cfg, generator=generator)),
            "post_norm": init_norm(cfg.norm, cfg.d_model),
            "ffn": (init_mlp(cfg.d_model, cfg.d_ff, generator=generator)
                    if ffn == "dense" else init_moe(cfg, generator=generator))}


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
    and ``segments``, a list (one per segment) of per-layer dicts. A
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
    return _to(params, device)


# ----------------------------------------------------------------- blocks

def _apply_block(bp: dict, cfg, mixer: str, ffn: str, x, positions, *,
                 cache=None, cache_index=None, cos_sin=None):
    """Pre-norm residual block -> (x, cache, aux_loss); ``aux_loss`` is the
    MoE router's, 0 for a dense block."""
    h = apply_norm(cfg.norm, bp["pre_norm"], x, cfg.norm_eps)
    if mixer == "attn":
        mix, new_cache = attention(bp["mixer"], cfg, h, positions,
                                   cache=cache, cache_index=cache_index,
                                   cos_sin=cos_sin)
    else:
        mix, new_cache = mamba(bp["mixer"], cfg, h, cache=cache)
    x = x + mix
    h = apply_norm(cfg.norm, bp["post_norm"], x, cfg.norm_eps)
    if ffn == "dense":
        return x + mlp(bp["ffn"], h, cfg.activation), new_cache, \
            x.new_zeros((), dtype=torch.float32)
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
                  cache_index=None, remat=False):
    """Every layer in order -> (x, summed aux_loss). ``caches``
    (per-segment stacked) are updated in place: attention writes its KV
    slot itself, a Mamba layer's new state and window are copied into its
    slice. The RoPE angles are computed once for all layers. ``remat``
    (no caches) recomputes each block's activations in the backward."""
    cos_sin = rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)
    aux = x.new_zeros((), dtype=torch.float32)
    for si, (mixer, ffn, _) in enumerate(segment_plan(cfg)):
        for j, bp in enumerate(params["segments"][si]):
            if remat:
                # the model draws no random numbers: no RNG state to keep
                x, a = checkpoint(_remat_block, bp, cfg, mixer, ffn, x,
                                  positions, cos_sin, use_reentrant=False,
                                  preserve_rng_state=False)
                aux = aux + a
                continue
            lc = None if caches is None else _layer_cache(caches[si], j)
            x, nc, a = _apply_block(bp, cfg, mixer, ffn, x, positions,
                                    cache=lc, cache_index=cache_index,
                                    cos_sin=cos_sin)
            aux = aux + a
            if lc is not None and mixer == "mamba":
                lc.h.copy_(nc.h)
                lc.conv.copy_(nc.conv)
    return x, aux


def _remat_block(bp, cfg, mixer, ffn, x, positions, cos_sin):
    x, _, a = _apply_block(bp, cfg, mixer, ffn, x, positions,
                           cos_sin=cos_sin)
    return x, a


def _lm_head(params, cfg, hidden):
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    logits = hidden @ w
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _embed(params, cfg, tokens):
    return params["embed"][tokens].to(getattr(torch, cfg.dtype))


def _forward_hidden(params, cfg, tokens, *, remat=False):
    B, T = tokens.shape
    x = _embed(params, cfg, tokens)
    positions = torch.arange(T, device=tokens.device)[None].expand(B, T)
    x, aux = _run_segments(params, cfg, x, positions, remat=remat)
    return apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps), aux


def hidden_states(params, cfg: ModelConfig, tokens) -> torch.Tensor:
    """Teacher-forced pass to the final norm: (B, T) -> (B, T, d)."""
    return _forward_hidden(params, cfg, tokens)[0]


def forward(params, cfg: ModelConfig, tokens, *, remat: bool = False
            ) -> LMOut:
    """Teacher-forced forward. tokens: (B, T) int -> logits (B, T, V) and
    the MoE layers' summed aux loss."""
    hidden, aux = _forward_hidden(params, cfg, tokens, remat=remat)
    return LMOut(logits=_lm_head(params, cfg, hidden), aux_loss=aux,
                 hidden=hidden)


def lm_loss(params, cfg: ModelConfig, tokens, *, remat: bool = True
            ) -> torch.Tensor:
    """Next-token cross-entropy over the (B, T - 1) targets, in float32,
    plus the MoE aux loss (the reference's ``lm_loss`` without its MTP
    branch: :func:`check_supported` refuses MTP). The head runs on the
    first T - 1 positions only, which gives the same logits as the
    reference's slice of the full (B, T, V) array without making it."""
    hidden, aux = _forward_hidden(params, cfg, tokens, remat=remat)
    logits = _lm_head(params, cfg, hidden[:, :-1]).float()
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          tokens[:, 1:].reshape(-1).long())
    return nll + aux


def prefill(params, cfg: ModelConfig, tokens) -> LMOut:
    """Prefill = the teacher-forced forward (inference)."""
    return forward(params, cfg, tokens)


# ----------------------------------------------------------------- decode

def init_caches(cfg: ModelConfig, batch: int, seq_len: int, *, device=None,
                dtype=None) -> list:
    """Per-segment stacked caches for decode, zeros, on ``device`` (cuda
    unless ``device="cpu"``): a KVCache of ``seq_len`` positions for an
    attention segment, a MambaCache for a Mamba one."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.dtype)
    caches = []
    for mixer, _, n in segment_plan(cfg):
        one = (init_cache(cfg, batch, seq_len, device=device, dtype=dtype)
               if mixer == "attn"
               else init_mamba_cache(cfg, batch, device=device, dtype=dtype))
        caches.append(type(one)(*(t.new_zeros((n,) + t.shape) for t in one)))
    return caches


def decode_step(params, cfg: ModelConfig, token, caches, index):
    """One-token decode. token: (B, 1) int; index: the position (int).

    Returns (logits (B, 1, V), caches), the caches updated in place."""
    B = token.shape[0]
    index = int(index)
    x = _embed(params, cfg, token)
    positions = torch.full((B, 1), index, dtype=torch.int64,
                           device=token.device)
    x, _ = _run_segments(params, cfg, x, positions, caches=caches,
                         cache_index=index)
    hidden = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    return _lm_head(params, cfg, hidden), caches
