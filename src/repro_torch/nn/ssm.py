"""Mamba-style selective SSM (Jamba's mixer layers).

Port of ``repro.nn.ssm``. The reference runs the recurrence as a chunked
``lax.scan`` with an ``associative_scan`` inside (``_selective_scan_fused``
for prefill) and as one explicit step in decode; both are the single call
:func:`repro_torch.kernels.ops.selective_scan` here, the hand-written
kernel on the card: T > 1 in prefill, T = 1 in decode with the cached
state as ``h0``.

Decode carries a :class:`MambaCache` of the state and the last K - 1 conv
inputs. ``jax.nn.softplus`` is ``logaddexp(x, 0)``; ``F.softplus`` returns
x itself above 20, which differs from it by at most 2e-9 relative.

On a device mesh the mixer's channels (d_inner) lie on the 'model' axis
(``hints.ffn_hidden`` on x, z and dt; the reference leaves the layout to
XLA), so the conv and the scan's kernel run on each rank's channels.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import hints, resolve_device
from repro_torch.kernels import ops
from repro_torch.nn.layers import (_draw_device, causal_conv1d, dense_init,
                                   init_causal_conv1d)


class MambaCache(NamedTuple):
    h: torch.Tensor          # (B, d_inner, d_state)
    conv: torch.Tensor       # (B, d_conv - 1, d_inner) trailing inputs


def dt_rank(cfg) -> int:
    return cfg.ssm.dt_rank if cfg.ssm.dt_rank else -(-cfg.d_model // 16)


def init_mamba(cfg, *, generator: Optional[torch.Generator] = None) -> dict:
    """The reference's parameters and init scales, drawn on the generator's
    device: dense weights (in, out) U(±1/sqrt(in)), the conv kernel (K,
    di), ``A_log = log(1..N)`` per channel (S4D-real), ``D`` ones and
    ``dt_bias`` the inverse softplus of a log-uniform dt in [1e-3, 0.1]."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    dtr = dt_rank(cfg)
    dev = _draw_device(generator)
    u = torch.rand((di,), generator=generator, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    A = torch.arange(1, s.d_state + 1, dtype=torch.float32,
                     device=dev)[None].repeat(di, 1)
    return {
        "in_proj": dense_init(d, 2 * di, generator=generator),
        "conv": init_causal_conv1d(di, s.d_conv, generator=generator),
        "x_proj": dense_init(di, dtr + 2 * s.d_state, generator=generator),
        "dt_proj": dense_init(dtr, di, generator=generator),
        "dt_bias": torch.log(torch.expm1(dt.clamp(min=1e-4))),
        "A_log": torch.log(A),
        "D": torch.ones((di,), device=dev),
        "out_proj": dense_init(di, d, generator=generator),
    }


def scan_inputs(params: dict, cfg, x: torch.Tensor,
                cache: Optional[MambaCache] = None):
    """The mixer up to the scan: x (B, T, d) -> (decay, inp (B, T, di, N),
    C (B, T, N), h0 (B, di, N), xc (B, T, di), z (B, T, di), conv_tail
    (B, K - 1, di)).

    ``decay`` and ``inp`` are materialised, as the reference does: at a
    prefill of 8 x 1,024 tokens with di 8,192 each is 4 GiB. Each is made
    by one allocation and finished in place (``exp_``), so no third
    (B, T, di, N) temporary lives beside them."""
    s = cfg.ssm
    B, T, _ = x.shape
    di, K, N = s.expand * cfg.d_model, s.d_conv, s.d_state
    dtr = dt_rank(cfg)

    # on a device mesh the channels lie on 'model' (hints.ffn_hidden), so
    # that the conv and the scan run on each rank's channels
    xs, z = (hints.ffn_hidden(t)
             for t in (x @ params["in_proj"]).split(di, dim=-1))
    if cache is None:
        xc = causal_conv1d(params["conv"], xs)
        conv_tail = xs[:, -(K - 1):] if T >= K - 1 else F.pad(
            xs, (0, 0, K - 1 - T, 0))
        h0 = x.new_zeros((B, di, N), dtype=torch.float32)
    else:
        # decode: the cached window, then this step's input
        xfull = torch.cat([cache.conv, xs], dim=1)
        xc = torch.einsum("bkc,kc->bc", xfull[:, -K:],
                          params["conv"]["kernel"])[:, None]
        conv_tail = xfull[:, -(K - 1):]
        h0 = cache.h
    xc = F.silu(xc)

    proj = xc @ params["x_proj"]                          # (B, T, dtr+2N)
    dt_in, Bmat = proj[..., :dtr], proj[..., dtr:dtr + N]
    Cmat = proj[..., dtr + N:].float().contiguous()
    dt = hints.ffn_hidden(F.softplus(dt_in @ params["dt_proj"]
                                     + params["dt_bias"]).float())
    A = -torch.exp(params["A_log"])                       # (di, N)

    decay = (dt[..., None] * A).exp_()
    inp = (dt * xc.float())[..., None] * Bmat.float()[:, :, None, :]
    return decay, inp, Cmat, h0.contiguous(), xc, z, conv_tail.contiguous()


def mamba(params: dict, cfg, x: torch.Tensor, *,
          cache: Optional[MambaCache] = None):
    """x (B, T, d) -> (out (B, T, d), MambaCache). Prefill when ``cache``
    is None, a decode step from ``cache`` otherwise; either way one launch
    of the selective-scan kernel on the card."""
    decay, inp, Cmat, h0, xc, z, conv_tail = scan_inputs(params, cfg, x,
                                                         cache)
    y, h_last = ops.selective_scan(decay, inp, Cmat, h0)
    del decay, inp
    y = y + params["D"] * xc.float()
    y = y.to(x.dtype) * F.silu(z)
    return y @ params["out_proj"], MambaCache(h=h_last, conv=conv_tail)


def init_mamba_cache(cfg, batch: int, *, device=None,
                     dtype=torch.float32) -> MambaCache:
    """Zero state (B, di, N) float32 and conv window (B, K - 1, di) on
    ``device`` (cuda unless ``device="cpu"``)."""
    device = resolve_device(device)
    s = cfg.ssm
    di = s.expand * cfg.d_model
    return MambaCache(
        h=torch.zeros((batch, di, s.d_state), dtype=torch.float32,
                      device=device),
        conv=torch.zeros((batch, s.d_conv - 1, di), dtype=dtype,
                         device=device))
