"""Base layers: the DVQ-AE's convs and the LM's norms, gated MLP and the
Mamba mixer's causal depthwise conv.

Port of ``repro.nn.layers``. The LM layers are functions over parameter
dicts with the reference's names (``scale``, ``bias``, ``wi``/``wg``/``wo``)
and dense weights kept (in, out), used as ``x @ w``; ``rmsnorm`` runs the
hand-written kernel through :func:`repro_torch.kernels.ops.rmsnorm`.
``mlp`` lays its hidden layer out by ``hints.ffn_hidden`` (d_ff on
'model' on a device mesh, an identity off one). The public functions keep the reference's layouts —
NHWC / NTC activations — and take PyTorch's weight layouts (OIHW / OIH);
they permute inside. The modules (:class:`Conv2d`, :class:`Conv1d`) work in
PyTorch's own NCHW / NCT layout, so an encoder permutes once at entry and
once at exit.

Padding is XLA's ``SAME`` rule, which PyTorch's ``padding="same"`` does
not give at stride > 1: total = max((ceil(n/s) - 1)*s + k - n, 0), low =
total // 2, high = the rest. Variances are population variances (ddof 0),
as ``jnp.var`` computes them.

The reference's transposed conv is ``lax.conv_transpose(...,
padding="SAME")`` with ``transpose_kernel=False``: the HWIO kernel runs
UNFLIPPED, as a plain correlation, over the stride-dilated input padded
by lax's transpose rule (:func:`transpose_same_padding`). The port keeps
that kernel as an OIHW conv weight and runs it through
``F.conv_transpose2d`` with the weight's in/out axes swapped and its taps
flipped, which computes the same correlation.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import hints
from repro_torch.kernels import ops


def same_padding(size: int, ksize: int, stride: int) -> Tuple[int, int]:
    """XLA ``SAME`` padding (low, high) of one spatial axis."""
    total = max((-(-size // stride) - 1) * stride + ksize - size, 0)
    return total // 2, total - total // 2


def _conv2d_nchw(x, weight, bias, stride: int):
    kh, kw = weight.shape[-2:]
    ph = same_padding(x.shape[-2], kh, stride)
    pw = same_padding(x.shape[-1], kw, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, weight, bias, stride=stride)


def transpose_same_padding(ksize: int, stride: int) -> Tuple[int, int]:
    """lax's ``SAME`` padding (low, high) of the stride-dilated input of a
    transposed conv (``lax._conv_transpose_padding``); the output is
    ``size * stride`` long."""
    pad_len = ksize + stride - 2
    low = ksize - 1 if stride > ksize - 1 else -(-pad_len // 2)
    return low, pad_len - low


def _conv2d_transpose_nchw(x, weight, bias, stride: int):
    """``F.conv_transpose2d`` at padding p computes the correlation over
    the dilated input padded by k-1-p on each side; the rest of lax's
    (low, high) padding is taken off or added after it."""
    k = weight.shape[-1]
    low, high = transpose_same_padding(k, stride)
    p = max(0, k - 1 - max(low, high))
    w = weight.transpose(0, 1).flip(2, 3)
    lo, hi = low - (k - 1 - p), high - (k - 1 - p)
    if lo == hi == 0:
        return F.conv_transpose2d(x, w, bias, stride=stride, padding=p)
    y = F.pad(F.conv_transpose2d(x, w, stride=stride, padding=p),
              (lo, hi, lo, hi))
    return y + bias[None, :, None, None]


def _conv1d_nct(x, weight, bias, stride: int):
    p = same_padding(x.shape[-1], weight.shape[-1], stride)
    return F.conv1d(F.pad(x, p), weight, bias, stride=stride)


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           stride: int = 1) -> torch.Tensor:
    """NHWC conv with an OIHW weight and XLA ``SAME`` padding."""
    y = _conv2d_nchw(x.permute(0, 3, 1, 2), weight, bias, stride)
    return y.permute(0, 2, 3, 1)


def conv2d_transpose(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """NHWC transposed conv with an OIHW weight (the reference's HWIO
    kernel by ``transpose(3, 2, 0, 1)``), lax ``SAME`` padding: the output
    is ``stride`` times the input's size."""
    y = _conv2d_transpose_nchw(x.permute(0, 3, 1, 2), weight, bias, stride)
    return y.permute(0, 2, 3, 1)


def conv1d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           stride: int = 1) -> torch.Tensor:
    """NTC conv with an OIH weight and XLA ``SAME`` padding."""
    return _conv1d_nct(x.transpose(1, 2), weight, bias, stride) \
        .transpose(1, 2)


def _instance_norm(x, dims, eps: float):
    mu = x.mean(dim=dims, keepdim=True)
    sigma = torch.sqrt(x.var(dim=dims, unbiased=False, keepdim=True) + eps)
    return (x - mu) / sigma


def instance_norm_2d(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm over the spatial dims of NHWC input (Eq. 4)."""
    return _instance_norm(x, (1, 2), eps)


def instance_norm_1d(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm over the time dim of NTC input (speech path)."""
    return _instance_norm(x, (1,), eps)


def _draw_device(generator: Optional[torch.Generator]):
    return None if generator is None else generator.device


def uniform_init(shape, scale: float, *,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32) -> torch.Tensor:
    """U(-scale, scale) from an explicit generator, on its device (the CPU
    without one). Formed in place: a 3.8 GB expert stack drawn on the card
    makes no temporaries."""
    return torch.rand(shape, generator=generator, dtype=dtype,
                      device=_draw_device(generator)) \
        .mul_(2.0).sub_(1.0).mul_(scale)


def dense_init(d_in: int, d_out: int, *,
               generator: Optional[torch.Generator] = None,
               name_scale: float = 1.0) -> torch.Tensor:
    """(d_in, d_out) weight used as ``x @ w``, U(±name_scale/sqrt(d_in))."""
    return uniform_init((d_in, d_out), name_scale / math.sqrt(d_in),
                        generator=generator)


def embed_init(vocab: int, d: int, *,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(vocab, d) embedding, N(0, 1) * 0.02, on the generator's device."""
    return torch.randn((vocab, d), generator=generator,
                       device=_draw_device(generator)).mul_(0.02)


# ------------------------------------------------------------------ norms

def init_rmsnorm(d: int) -> dict:
    return {"scale": torch.ones(d)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis, through the hand-written kernel."""
    return ops.rmsnorm(x, params["scale"], eps=eps)


def init_layernorm(d: int) -> dict:
    return {"scale": torch.ones(d), "bias": torch.zeros(d)}


def layernorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * params["scale"].float() + params["bias"].float()
    return out.to(x.dtype)


def init_norm(kind: str, d: int) -> dict:
    return init_rmsnorm(d) if kind == "rmsnorm" else init_layernorm(d)


def apply_norm(kind: str, params: dict, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    return rmsnorm(params, x, eps) if kind == "rmsnorm" \
        else layernorm(params, x, eps)


# ------------------------------------------------------------ activations

def act_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu
    raise ValueError(f"unknown activation {name}")


# -------------------------------------------------------------- gated MLP

def init_mlp(d_model: int, d_ff: int, *,
             generator: Optional[torch.Generator] = None) -> dict:
    """SwiGLU/GeGLU gated MLP: wi (gate), wg (up), wo (down)."""
    return {"wi": dense_init(d_model, d_ff, generator=generator),
            "wg": dense_init(d_model, d_ff, generator=generator),
            "wo": dense_init(d_ff, d_model, generator=generator)}


def mlp(params: dict, x: torch.Tensor, activation: str = "silu") -> torch.Tensor:
    h = act_fn(activation)(x @ params["wi"]) * (x @ params["wg"])
    return hints.ffn_hidden(h) @ params["wo"]


# ------------------------------------------------------ causal depthwise

def init_causal_conv1d(channels: int, ksize: int, *,
                       generator: Optional[torch.Generator] = None) -> dict:
    """Depthwise kernel (K, C), U(±1/sqrt(K)), the reference's layout."""
    return {"kernel": uniform_init((ksize, channels), 1.0 / math.sqrt(ksize),
                                   generator=generator)}


def causal_conv1d(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv of the Mamba mixer, no bias: x (B, T, C) and
    ``params["kernel"]`` (K, C) -> (B, T, C), x left-padded by K - 1.
    ``F.conv1d`` with groups C and the weight as (C, 1, K) computes it:
    both frameworks cross-correlate, so the taps are not flipped."""
    k = params["kernel"]
    if hints.is_dtensor(x):             # each rank's (batch, channel) shard
        from repro_torch.kernels._mesh import depthwise_mesh
        return depthwise_mesh(lambda a, w: causal_conv1d({"kernel": w}, a),
                              x, k)
    K, C = k.shape
    xt = F.pad(x.transpose(1, 2), (K - 1, 0))
    return F.conv1d(xt, k.T.unsqueeze(1), groups=C).transpose(1, 2) \
        .contiguous()


class Conv2d(nn.Module):
    """NCHW conv with an OIHW weight and XLA ``SAME`` padding."""

    def __init__(self, c_in: int, c_out: int, ksize: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        scale = 1.0 / math.sqrt(c_in * ksize * ksize)
        self.weight = nn.Parameter(uniform_init(
            (c_out, c_in, ksize, ksize), scale, generator=generator))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        return _conv2d_nchw(x, self.weight, self.bias, stride)


class ConvTranspose2d(Conv2d):
    """NCHW transposed conv, lax ``SAME`` padding; its weight is OIHW as
    the reference's HWIO kernel is laid out (in = c_in, out = c_out), with
    the reference's init scale ``1/sqrt(c_in * k * k)``."""

    def forward(self, x: torch.Tensor, stride: int = 2) -> torch.Tensor:
        return _conv2d_transpose_nchw(x, self.weight, self.bias, stride)


class Conv1d(nn.Module):
    """NCT conv with an OIH weight and XLA ``SAME`` padding."""

    def __init__(self, c_in: int, c_out: int, ksize: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        scale = 1.0 / math.sqrt(c_in * ksize)
        self.weight = nn.Parameter(uniform_init(
            (c_out, c_in, ksize), scale, generator=generator))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        return _conv1d_nct(x, self.weight, self.bias, stride)
