"""Attention: GQA self-attention with RoPE, qk-norm, sliding window and a
KV cache.

Port of ``repro.nn.attention``: self-attention and the Whisper decoder's
cross-attention. Two compute paths, as in the reference:

  * the hand-written flash kernel (:func:`repro_torch.kernels.ops
    .flash_attention`) for every call without a cache mask and with more
    than one query: prefill, the teacher-forced forward, the Whisper
    encoder (non-causal) and cross-attention at T > 1 (non-causal, T
    queries against the encoder's frames). The reference
    picks its plain ``_attend_full`` below 8192^2 score pairs and its
    chunked online softmax above; all three compute the same function.
    The kernel is built for the head dims ``HEAD_DIMS``; :func:`attend`
    runs any other width up to 256 at the narrowest of them that holds it
    (:func:`flash_width`): q, k and v padded with zero columns, which add
    0 to every score and every output column, q first multiplied by
    ``sqrt(D' / D)`` so that the kernel's scale ``1/sqrt(D')`` gives the
    reference's ``1/sqrt(D)``, and the output sliced back. The MTP block
    of deepseek-v3 (56) runs at 64, MLA's v (narrower than its q and k)
    at q/k's width. The CPU takes the same route through the kernel's plain
    version; nothing falls back to the plain path on the card.
  * the plain :func:`_attend_full` for a decode step (one query against
    the cache under its valid-length mask, or against the encoder's frames
    in cross-attention), as the reference computes it outside any
    kernel.

GQA never repeats k and v: the kernel reads KV head ``h // q_per_kv``,
and :func:`_attend_full` groups the query heads by KV head.

``hints.heads`` / ``hints.kv_heads`` lay q and k, v out on a device mesh
(heads on 'model') and are identities off one. A decode step writes the new key and
value into the cache in place (the reference's ``dynamic_update_slice``
returns a new array); the returned cache is the same tensors.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import hints, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import HEAD_DIMS

from .layers import dense_init, init_rmsnorm, rmsnorm

NEG_INF = -1e30


# ------------------------------------------------------------------- RoPE

def rope_freqs(head_dim: int, theta: float) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32)
                            / head_dim))


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T) positions -> (cos, sin), each (B, T, 1, head_dim / 2) float32.

    The angles depend only on the positions, so a forward computes them
    once for all its layers; the reference recomputes them in every
    layer, with the same numbers."""
    inv = rope_freqs(head_dim, theta).to(positions.device)
    ang = positions[..., None].float() * inv
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def rotate(x: torch.Tensor, cos_sin) -> torch.Tensor:
    """Rotate the two halves of x's head dim (not interleaved pairs) by
    ``rope_cos_sin``'s angles, in float32."""
    cos, sin = cos_sin
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, T, H, D); positions: (B, T) int."""
    return rotate(x, rope_cos_sin(positions, x.shape[-1], theta))


# ----------------------------------------------------------------- params

def init_attention(cfg, *, generator: Optional[torch.Generator] = None
                   ) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    p = {"wq": dense_init(d, nq * hd, generator=generator),
         "wk": dense_init(d, nkv * hd, generator=generator),
         "wv": dense_init(d, nkv * hd, generator=generator),
         "wo": dense_init(nq * hd, d, generator=generator)}
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd)
        p["k_norm"] = init_rmsnorm(hd)
    return p


# ------------------------------------------------------------------ cores

def _attend_full(q, k, v, *, causal: bool, window: int = 0,
                 kv_len_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k: (B, Tq | Tk, Hq | Hkv, D), v: (B, Tk, Hkv, Dv) -> (B, Tq,
    Hq, Dv).

    Plain softmax attention. Where the reference repeats k and v to Hq
    heads first, this groups the Hq query heads into Hkv groups of
    ``Hq // Hkv``: query head ``h`` meets KV head ``h // (Hq // Hkv)``
    either way."""
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Tq, Hkv, H // Hkv, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) \
        * (1.0 / math.sqrt(D))
    qpos = torch.arange(Tq, device=q.device)[:, None]
    kpos = torch.arange(Tk, device=q.device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    if kv_len_mask is not None:                  # (B, Tk) valid-cache mask
        mask = mask & kv_len_mask[:, None, None, None, :]
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(B, Tq, H, v.shape[-1]).to(q.dtype)


def flash_width(qk_head_dim: int, v_head_dim: int) -> int:
    """The flash kernel's head dim that q and k of ``qk_head_dim`` and v
    of ``v_head_dim`` run at: the narrowest of ``HEAD_DIMS`` holding
    both."""
    for D in HEAD_DIMS:
        if D >= max(qk_head_dim, v_head_dim):
            return D
    raise NotImplementedError(
        f"head widths q/k {qk_head_dim}, v {v_head_dim}: the flash "
        f"kernel's head dims are {HEAD_DIMS}")


def attend(q, k, v, *, causal: bool = True, window: int = 0,
           kv_len_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The flash kernel without a cache mask and with more than one
    query; the plain path otherwise. Inputs RoPE'd and normed; q (B, Tq,
    Hq, D), k (B, Tk, Hkv, D), v (B, Tk, Hkv, Dv) -> (B, Tq, Hq, Dv). The
    kernel runs at :func:`flash_width` D': q, k and v padded with zero
    columns to it where narrower, q first scaled by ``sqrt(D' / D)``, the
    output sliced back to Dv: the function of the scale ``1/sqrt(D)``."""
    if kv_len_mask is not None or q.shape[1] <= 1:
        if hints.is_dtensor(q):         # each rank's (batch, head) shard
            from repro_torch.kernels._mesh import heads_local
            return heads_local(lambda a, b, c, m: _attend_full(
                a, b, c, causal=causal, window=window, kv_len_mask=m),
                q, k, v, kv_len_mask)
        return _attend_full(q, k, v, causal=causal, window=window,
                            kv_len_mask=kv_len_mask)
    dqk, dv = q.shape[-1], v.shape[-1]
    D = flash_width(dqk, dv)
    if D > dqk:                          # the kernel scales by 1/sqrt(D)
        q = F.pad(q * math.sqrt(D / dqk), (0, D - dqk))
        k = F.pad(k, (0, D - dqk))
    if D > dv:
        v = F.pad(v, (0, D - dv))
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    return out[..., :dv] if D > dv else out


# ----------------------------------------------------------------- module

class KVCache(NamedTuple):
    k: torch.Tensor          # (B, S, n_kv, head_dim)
    v: torch.Tensor
    # position index is carried once per model, not per layer


def attention(params: dict, cfg, x: torch.Tensor, positions: torch.Tensor, *,
              cache: Optional[KVCache] = None, cache_index: Optional[int] = None,
              cos_sin=None):
    """Self-attention forward.

    Train/prefill: ``cache is None`` -> (out, KVCache of this call's k, v).
    Decode: ``cache`` given, x is (B, 1, d); k and v go into the cache at
    ``cache_index`` in place -> (out, the same cache). ``cos_sin`` is
    ``rope_cos_sin(positions, ...)`` when the caller has it already."""
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    window = cfg.sliding_window
    q = hints.heads(hints.split_heads(x @ params["wq"], cfg.n_heads))
    k = hints.kv_heads(hints.split_heads(x @ params["wk"], cfg.n_kv_heads))
    v = hints.kv_heads(hints.split_heads(x @ params["wv"], cfg.n_kv_heads))
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    if cos_sin is None:
        cos_sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    q = rotate(q, cos_sin)
    k = rotate(k, cos_sin)

    if cache is None:
        out = attend(q, k, v, causal=True, window=window)
        new_cache = KVCache(k=k, v=v)
    else:
        S = cache.k.shape[1]
        idx = int(cache_index)
        hints.write_slot(cache.k, idx, k)
        hints.write_slot(cache.v, idx, v)
        kpos = torch.arange(S, device=x.device)[None, :]
        valid = kpos <= idx
        if window:
            valid &= kpos > idx - window
        out = attend(q, cache.k, cache.v, causal=False,
                     kv_len_mask=valid.expand(B, S))
        new_cache = cache
    out = out.reshape(B, T, cfg.n_heads * hd) @ params["wo"]
    return out, new_cache


def init_cache(cfg, batch: int, seq_len: int, *, device=None,
               dtype=torch.float32) -> KVCache:
    """Zero k and v (B, seq_len, n_kv_heads, head_dim) on ``device``
    (cuda unless ``device="cpu"``)."""
    device = resolve_device(device)
    hd = cfg.resolved_head_dim
    shape = (batch, seq_len, cfg.n_kv_heads, hd)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


# ------------------------------------------------ cross-attention (Whisper)

def init_cross_attention(cfg, *, generator: Optional[torch.Generator] = None
                         ) -> dict:
    """A decoder block's cross-attention: wq, wk, wv, wo as self-attention
    draws them, without qk-norm."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {"wq": dense_init(d, cfg.n_heads * hd, generator=generator),
            "wk": dense_init(d, cfg.n_kv_heads * hd, generator=generator),
            "wv": dense_init(d, cfg.n_kv_heads * hd, generator=generator),
            "wo": dense_init(cfg.n_heads * hd, d, generator=generator)}


def cross_attention(params: dict, cfg, x: torch.Tensor,
                    enc_out: torch.Tensor) -> torch.Tensor:
    """x (B, T, d) decoder states, enc_out (B, Tsrc, d) -> (B, T, d).
    Queries from ``x``, keys and values from ``enc_out``; no RoPE, no
    qk-norm, no mask. At T > 1 the flash kernel (T queries, Tsrc keys), at
    a decode step the plain path; k and v are recomputed from ``enc_out``
    on every call, as in the reference."""
    B, T, _ = x.shape
    Ts = enc_out.shape[1]
    hd = cfg.resolved_head_dim
    q = hints.heads(hints.split_heads(x @ params["wq"], cfg.n_heads))
    k = hints.kv_heads(hints.split_heads(enc_out @ params["wk"],
                                         cfg.n_kv_heads))
    v = hints.kv_heads(hints.split_heads(enc_out @ params["wv"],
                                         cfg.n_kv_heads))
    out = attend(q, k, v, causal=False)
    return out.reshape(B, T, cfg.n_heads * hd) @ params["wo"]
