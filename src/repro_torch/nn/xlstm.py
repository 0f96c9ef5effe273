"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, sequential), arXiv:2405.04517.

Port of ``repro.nn.xlstm``. The reference has no Pallas kernel here: both
mixers are plain ``jnp`` under ``lax.scan``, and the port is plain
PyTorch, a Python loop where the reference scans.

* mLSTM runs the chunkwise-parallel form: a loop over chunks of
  :data:`MLSTM_CHUNK` steps carrying the (C, n, m) state, exact stabilised
  exponential gating inside each chunk. T is padded to whole chunks with
  input gate -1e30 and log forget gate 0, so padded steps add nothing to
  the chunk-end state; their outputs are sliced away. A decode step (T =
  1) is one chunk of length 1 on the cached state, its causal conv the
  cached K - 1 inputs and this one.
* sLSTM is a T-step sequential loop over its recurrent block-diagonal
  weights (one (B, 4d) step at a time: about 15 small launches a step on
  the card, host-bound at prefill) with its GeGLU post-projection.

:data:`NH` = 4 heads is a module constant, as in the reference, not
``cfg.n_heads``. The gate weights ``w_if``, the recurrent ``r`` and its
``bias`` are float32 whatever the model's dtype, and so is every state.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.nn.layers import (_draw_device, causal_conv1d, dense_init,
                                   init_causal_conv1d, uniform_init)

MLSTM_CHUNK = 128
NH = 4                       # the assigned config's 4 heads
M_INIT = -1e30               # the stabiliser's start: no history yet


class MLSTMCache(NamedTuple):
    C: torch.Tensor          # (B, NH, DH, DH)
    n: torch.Tensor          # (B, NH, DH)
    m: torch.Tensor          # (B, NH)
    conv: torch.Tensor       # (B, K - 1, di)


class SLSTMCache(NamedTuple):
    c: torch.Tensor          # (B, d)
    n: torch.Tensor          # (B, d)
    h: torch.Tensor          # (B, d)
    m: torch.Tensor          # (B, d)


def inner_dim(cfg) -> int:
    return int(cfg.xlstm.proj_factor * cfg.d_model)


def ffn_dim(cfg) -> int:
    return int(cfg.xlstm.slstm_proj_factor * cfg.d_model)


def _scale(dh: int) -> float:
    """``1 / sqrt(DH)`` formed in float32, as the reference forms it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


# ================================================================= mLSTM

def init_mlstm(cfg, *, generator: Optional[torch.Generator] = None) -> dict:
    """The reference's mLSTM parameters and init scales, drawn on the
    generator's device: dense weights (in, out) U(±1/sqrt(in)), the conv
    kernel (K, di), ``skip_scale`` ones."""
    d, di = cfg.d_model, inner_dim(cfg)
    return {
        "up_proj": dense_init(d, 2 * di, generator=generator),
        "conv": init_causal_conv1d(di, cfg.xlstm.conv_dim,
                                   generator=generator),
        "wq": dense_init(di, di, generator=generator),
        "wk": dense_init(di, di, generator=generator),
        "wv": dense_init(di, di, generator=generator),
        "w_if": dense_init(di, 2 * NH, generator=generator),
        "skip_scale": torch.ones((di,), device=_draw_device(generator)),
        "down_proj": dense_init(di, d, generator=generator),
    }


def _mlstm_chunk(q, k, v, ig, lf, C_in, n_in, m_in):
    """One chunk of stabilised mLSTM.

    q, k, v: (B, NH, L, DH); ig: (B, NH, L) log input gate; lf: (B, NH, L)
    log forget gate. Carry: C (B, NH, DH, DH), n (B, NH, DH), m (B, NH).
    Returns (h (B, NH, L, DH), C, n, m)."""
    L, DH = q.shape[-2:]
    scale = _scale(DH)
    b = torch.cumsum(lf, dim=-1)                       # (B, H, L) inclusive
    # intra-chunk log weights: g[t, s] = b_t - b_s + ig_s (s <= t)
    g = b[..., :, None] - b[..., None, :] + ig[..., None, :]
    tri = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    g = g.masked_fill(~tri, -math.inf)
    # stabiliser per target step
    m_t = torch.maximum(m_in[..., None] + b, g.amax(dim=-1))
    w = torch.exp(g - m_t[..., None])                  # (B, H, L, L)
    qk = torch.einsum("bhld,bhsd->bhls", q, k) * scale
    h_intra = torch.einsum("bhls,bhsd->bhld", w * qk, v)
    denom_intra = torch.einsum("bhls,bhsd->bhld", w, k)
    inter_scale = torch.exp(m_in[..., None] + b - m_t)
    qs = q * scale
    h_inter = torch.einsum("bhld,bhde->bhle", qs, C_in) \
        * inter_scale[..., None]
    denom = torch.einsum("bhld,bhd->bhl", qs, n_in) * inter_scale \
        + torch.einsum("bhld,bhld->bhl", q, denom_intra)
    h = (h_intra + h_inter) / torch.maximum(
        denom.abs(), torch.exp(-m_t))[..., None]
    # chunk-end state
    bL = b[..., -1:]                                   # (B, H, 1)
    m_out = torch.maximum(m_in + bL[..., 0], (bL - b + ig).amax(dim=-1))
    wk_end = torch.exp(bL - b + ig - m_out[..., None])  # (B, H, L)
    decay = torch.exp(m_in + bL[..., 0] - m_out)
    C_out = decay[..., None, None] * C_in \
        + torch.einsum("bhl,bhld,bhle->bhde", wk_end, k, v)
    n_out = decay[..., None] * n_in \
        + torch.einsum("bhl,bhld->bhd", wk_end, k)
    return h, C_out, n_out, m_out


def mlstm(params: dict, cfg, x: torch.Tensor, *,
          cache: Optional[MLSTMCache] = None, chunk: int = MLSTM_CHUNK):
    """x (B, T, d) -> (out (B, T, d), MLSTMCache). Prefill when ``cache``
    is None; with ``cache`` one decode step (T = 1)."""
    B, T, _ = x.shape
    di = inner_dim(cfg)
    DH = di // NH
    K = cfg.xlstm.conv_dim
    xb, z = (x @ params["up_proj"]).split(di, dim=-1)   # (B, T, di) each
    if cache is None:
        xconv = F.silu(causal_conv1d(params["conv"], xb))
        conv_tail = xb[:, -(K - 1):] if T >= K - 1 else F.pad(
            xb, (0, 0, K - 1 - T, 0))
    else:
        if T != 1:
            raise ValueError(f"an mLSTM decode step takes one token, got {T}")
        xfull = torch.cat([cache.conv, xb], dim=1)
        xconv = F.silu(torch.einsum("bkc,kc->bc", xfull[:, -K:],
                                    params["conv"]["kernel"])[:, None])
        conv_tail = xfull[:, -(K - 1):]

    def heads(t):
        return t.reshape(B, -1, NH, DH).transpose(1, 2).float()

    q = heads(xconv @ params["wq"])
    k = heads(xconv @ params["wk"])
    v = heads(xconv @ params["wv"])
    gates = (xconv @ params["w_if"]).float()            # (B, T, 2NH)
    ig = gates[..., :NH].transpose(1, 2)                # (B, NH, T) log-i
    lf = F.logsigmoid(gates[..., NH:]).transpose(1, 2)

    if cache is None:
        C = x.new_zeros((B, NH, DH, DH), dtype=torch.float32)
        n = x.new_zeros((B, NH, DH), dtype=torch.float32)
        m = x.new_full((B, NH), M_INIT, dtype=torch.float32)
    else:
        C, n, m = cache.C, cache.n, cache.m

    if T == 1:
        h, C, n, m = _mlstm_chunk(q, k, v, ig, lf, C, n, m)
    else:
        pad = -T % chunk
        if pad:
            q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
            ig = F.pad(ig, (0, pad), value=M_INIT)
            lf = F.pad(lf, (0, pad))
        hs = []
        for s in range(0, T + pad, chunk):
            sl = slice(s, s + chunk)
            h, C, n, m = _mlstm_chunk(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                      ig[..., sl], lf[..., sl], C, n, m)
            hs.append(h)
        h = torch.cat(hs, dim=2)[:, :, :T]

    h = h.transpose(1, 2).reshape(B, T, di).to(x.dtype)
    h = h + params["skip_scale"] * xconv
    out = (h * F.silu(z)) @ params["down_proj"]
    return out, MLSTMCache(C=C, n=n, m=m, conv=conv_tail.contiguous())


def init_mlstm_cache(cfg, batch: int, *, device=None,
                     dtype=torch.float32) -> MLSTMCache:
    """Zero C and n, m at -1e30 (float32) and a zero conv window (B, K -
    1, di) on ``device`` (cuda unless ``device="cpu"``)."""
    device = resolve_device(device)
    di = inner_dim(cfg)
    DH = di // NH
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMCache(
        C=torch.zeros((batch, NH, DH, DH), **f32),
        n=torch.zeros((batch, NH, DH), **f32),
        m=torch.full((batch, NH), M_INIT, **f32),
        conv=torch.zeros((batch, cfg.xlstm.conv_dim - 1, di), dtype=dtype,
                         device=device))


# ================================================================= sLSTM

def init_slstm(cfg, *, generator: Optional[torch.Generator] = None) -> dict:
    """The reference's sLSTM parameters: ``w_in`` (d, 4d) for the z, i, f,
    o pre-activations, the block-diagonal recurrent ``r`` (NH, DH, 4 DH)
    U(±1/sqrt(DH)), a zero ``bias`` (4d), and the GeGLU ``ffn_up`` (d, 2
    ffd) and ``ffn_down`` (ffd, d)."""
    d = cfg.d_model
    DH = d // NH
    ffd = ffn_dim(cfg)
    return {
        "w_in": dense_init(d, 4 * d, generator=generator),
        "r": uniform_init((NH, DH, 4 * DH), _scale(DH), generator=generator),
        "bias": torch.zeros((4 * d,), device=_draw_device(generator)),
        "ffn_up": dense_init(d, 2 * ffd, generator=generator),
        "ffn_down": dense_init(ffd, d, generator=generator),
    }


def _slstm_step(params: dict, d: int, carry, x_t: torch.Tensor):
    """x_t: (B, 4d) input pre-activations; carry (c, n, h, m), each (B, d)
    -> (the new carry, h)."""
    c, n, h, m = carry
    B = c.shape[0]
    rec = torch.einsum("bhd,hde->bhe", h.reshape(B, NH, d // NH),
                       params["r"]).reshape(B, 4 * d)
    zp, ip, fp, op = (x_t + rec + params["bias"]).chunk(4, dim=-1)
    z = torch.tanh(zp)
    o = torch.sigmoid(op)
    log_f = F.logsigmoid(fp)
    m_new = torch.maximum(log_f + m, ip)
    i = torch.exp(ip - m_new)
    f = torch.exp(log_f + m - m_new)
    c_new = f * c + i * z
    n_new = f * n + i
    h_new = o * c_new / torch.clamp(n_new.abs(), min=1.0)
    return (c_new, n_new, h_new, m_new), h_new


def slstm(params: dict, cfg, x: torch.Tensor, *,
          cache: Optional[SLSTMCache] = None):
    """x (B, T, d) -> (out (B, T, d), SLSTMCache): T sequential steps from
    ``cache`` (zeros and m = -1e30 without one), then the GeGLU
    post-projection (tanh GELU)."""
    B, T, d = x.shape
    pre = (x @ params["w_in"]).float()                   # (B, T, 4d)
    if cache is None:
        zero = x.new_zeros((B, d), dtype=torch.float32)
        carry = (zero, zero, zero,
                 x.new_full((B, d), M_INIT, dtype=torch.float32))
    else:
        carry = tuple(cache)
    hs = []
    for t in range(T):
        carry, h = _slstm_step(params, d, carry, pre[:, t])
        hs.append(h)
    hs = torch.stack(hs, dim=1).to(x.dtype)
    a, b = (hs @ params["ffn_up"]).chunk(2, dim=-1)
    out = (F.gelu(a, approximate="tanh") * b) @ params["ffn_down"]
    return out, SLSTMCache(*carry)


def init_slstm_cache(cfg, batch: int, *, device=None) -> SLSTMCache:
    """c, n, h zero and m at -1e30, each (B, d) float32, on ``device``
    (cuda unless ``device="cpu"``)."""
    device = resolve_device(device)
    shape = (batch, cfg.d_model)
    zeros = [torch.zeros(shape, dtype=torch.float32, device=device)
             for _ in range(3)]
    return SLSTMCache(*zeros, torch.full(shape, M_INIT, dtype=torch.float32,
                                         device=device))
