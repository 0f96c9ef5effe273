"""Multi-head Latent Attention (DeepSeek-V2/V3, MiniCPM3).

Port of ``repro.nn.mla``. KV is compressed into a per-token latent
``c_kv`` of rank ``kv_lora_rank`` plus one shared RoPE key of
``qk_rope_head_dim``; the decode cache holds only ``(c_kv, k_rope)``.
Two paths, as in the reference:

  * prefill (no cache), **expanded**: the latents go through ``wkv_b`` to
    per-head ``k_nope`` and ``v``; k is ``k_nope`` beside the shared
    ``k_rope`` broadcast to every head, so q and k are ``qk_head_dim``
    wide (96 at minicpm3-4b, 192 at deepseek-v3) and v is ``v_head_dim``
    wide (64, 128). The port runs it on the hand-written flash kernel
    (:func:`repro_torch.nn.attention.attend`) at D, the narrowest of its
    head dims (``HEAD_DIMS``) that holds both widths
    (:func:`repro_torch.nn.attention.flash_width`): v is padded with zero
    columns to D, and the output's extra columns are sliced off. A zero
    column of v adds exactly 0 to every output column. At minicpm3-4b and
    deepseek-v3 D is q/k's own 96 and 192, so the kernel's scale
    ``1/sqrt(D)`` is the reference's ``1/sqrt(qk_head_dim)`` and the
    sliced output is the same function. Where D is wider than q/k (the
    SMOKE configs' 48 runs at 64), q and k are padded with zero columns
    too, which add 0 to every score, and q is first multiplied by
    ``sqrt(D / qk_head_dim)`` so that the kernel's scale gives the
    reference's. That padding is ``attend``'s own, for every head width.
    The CPU runs it through the kernel's plain version. Nothing falls back
    to the plain path on the card; widths past the kernel's widest head
    dim raise.
  * decode (a cache), **absorbed**: ``wkv_b`` is folded into the query and
    the output, so the scores run over the rank-``kv_lora_rank`` latent
    plus the RoPE part and the S-long cache is never expanded. Plain
    tensor ops, as in the reference, which has no kernel for it. The step
    writes its (c_kv, k_rope) into the cache at ``cache_index`` in place
    (the reference's ``dynamic_update_slice`` returns new arrays) and
    returns the same tensors.

RoPE rotates at ``qk_rope_head_dim`` (32 at minicpm3-4b): the mixer
computes its own angles and never takes the forward's shared ones, which
are at ``cfg.resolved_head_dim``. ``q_norm`` and ``kv_norm`` run the
rmsnorm kernel (:func:`repro_torch.nn.layers.rmsnorm`). The reference's
``hints.heads`` is an identity off a mesh, so the port leaves it out.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch import hints, resolve_device

from .attention import NEG_INF, attend, rope_cos_sin, rotate
from .layers import dense_init, init_rmsnorm, rmsnorm


class MLACache(NamedTuple):
    c_kv: torch.Tensor       # (B, S, kv_lora_rank)
    k_rope: torch.Tensor     # (B, S, qk_rope_head_dim)


def init_mla(cfg, *, generator: Optional[torch.Generator] = None) -> dict:
    """The reference's MLA parameters and init scales: ``wq_a``,
    ``q_norm``, ``wq_b`` (or ``wq`` when ``q_lora_rank`` is 0), ``wkv_a``,
    ``kv_norm``, ``wkv_b``, ``wo``, dense weights (in, out)."""
    m = cfg.mla
    d, nq = cfg.d_model, cfg.n_heads
    p = {}
    if m.q_lora_rank:
        p["wq_a"] = dense_init(d, m.q_lora_rank, generator=generator)
        p["q_norm"] = init_rmsnorm(m.q_lora_rank)
        p["wq_b"] = dense_init(m.q_lora_rank, nq * m.qk_head_dim,
                               generator=generator)
    else:
        p["wq"] = dense_init(d, nq * m.qk_head_dim, generator=generator)
    p["wkv_a"] = dense_init(d, m.kv_lora_rank + m.qk_rope_head_dim,
                            generator=generator)
    p["kv_norm"] = init_rmsnorm(m.kv_lora_rank)
    p["wkv_b"] = dense_init(m.kv_lora_rank,
                            nq * (m.qk_nope_head_dim + m.v_head_dim),
                            generator=generator)
    p["wo"] = dense_init(nq * m.v_head_dim, d, generator=generator)
    return p


def mla_attention(params: dict, cfg, x: torch.Tensor,
                  positions: torch.Tensor, *,
                  cache: Optional[MLACache] = None,
                  cache_index: Optional[int] = None):
    """x (B, T, d), positions (B, T) -> (out (B, T, d), cache).

    Prefill (``cache is None``): the expanded path on the flash kernel ->
    (out, MLACache of this call's c_kv and k_rope). Decode: the absorbed
    path, the new latents written into ``cache`` at ``cache_index`` in
    place -> (out, the same cache)."""
    m = cfg.mla
    B, T, _ = x.shape
    nq, dn, dr, dv = (cfg.n_heads, m.qk_nope_head_dim, m.qk_rope_head_dim,
                      m.v_head_dim)
    dqk = m.qk_head_dim
    if m.q_lora_rank:
        q = rmsnorm(params["q_norm"], x @ params["wq_a"]) @ params["wq_b"]
    else:
        q = x @ params["wq"]
    q = hints.heads(hints.split_heads(q, nq))
    cos_sin = rope_cos_sin(positions, dr, cfg.rope_theta)
    q_nope, q_rope = q[..., :dn], rotate(q[..., dn:], cos_sin)
    ckr = x @ params["wkv_a"]
    c_kv = rmsnorm(params["kv_norm"], ckr[..., :m.kv_lora_rank])
    k_rope = rotate(ckr[..., None, m.kv_lora_rank:], cos_sin)[:, :, 0]

    if cache is None:
        kv = hints.split_heads(c_kv @ params["wkv_b"], nq)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([kv[..., :dn],
                       k_rope[:, :, None, :].expand(B, T, nq, dr)], dim=-1)
        out = attend(q, k, kv[..., dn:], causal=True)
        new_cache = MLACache(c_kv=c_kv, k_rope=k_rope)
    else:
        S = cache.c_kv.shape[1]
        idx = int(cache_index)
        hints.write_slot(cache.c_kv, idx, c_kv)
        hints.write_slot(cache.k_rope, idx, k_rope)
        w_b = hints.split_heads(params["wkv_b"], nq)
        w_kb, w_vb = w_b[..., :dn].float(), w_b[..., dn:].float()
        cc = cache.c_kv.float()
        q_lat = torch.einsum("bthn,lhn->bthl", q_nope.float(), w_kb)
        scores = (torch.einsum("bthl,bsl->bhts", q_lat, cc)
                  + torch.einsum("bthr,bsr->bhts", q_rope.float(),
                                 cache.k_rope.float()))
        scores = scores / math.sqrt(dqk)
        valid = torch.arange(S, device=x.device) <= idx
        scores = scores.masked_fill(~valid, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out_lat = torch.einsum("bhts,bsl->bthl", probs, cc)
        out = torch.einsum("bthl,lhv->bthv", out_lat, w_vb).to(x.dtype)
        new_cache = cache
    out = hints.merge_heads(out) @ params["wo"]
    return out, new_cache


def init_mla_cache(cfg, batch: int, seq_len: int, *, device=None,
                   dtype=torch.float32) -> MLACache:
    """Zero c_kv (B, seq_len, kv_lora_rank) and k_rope (B, seq_len,
    qk_rope_head_dim) on ``device`` (cuda unless ``device="cpu"``)."""
    device = resolve_device(device)
    m = cfg.mla
    return MLACache(
        c_kv=torch.zeros((batch, seq_len, m.kv_lora_rank), dtype=dtype,
                         device=device),
        k_rope=torch.zeros((batch, seq_len, m.qk_rope_head_dim), dtype=dtype,
                           device=device))
