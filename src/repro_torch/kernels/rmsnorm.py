"""Fused RMSNorm: the CUDA wrapper.

Port of ``repro.kernels.rmsnorm``: ``x * rsqrt(mean(x^2) + eps) * scale``
over the last axis of ``x`` (..., d), in float32, on x and scale each
float32 or bfloat16, the output in x's type (rounded once). The kernel is
``csrc/rmsnorm.cu``; its plain version is
:func:`repro_torch.kernels.ref.rmsnorm_ref`. The backward is
``csrc/rmsnorm_bwd.cu`` (:func:`rmsnorm_bwd_cuda`, plain version
:func:`repro_torch.kernels.ref.rmsnorm_bwd_ref`).

A decode step calls it 113 times on 8 rows, where the host's part of a call
is most of its time, so the arguments are checked in one pass and the
messages are built only for a refusal.
"""
from __future__ import annotations

import torch

from . import _build
from ._dtypes import BF16, LM_DTYPES, require_lm


def _refuse(x: torch.Tensor, scale: torch.Tensor, cuda: bool):
    require_lm(x, "x", cuda=cuda)
    require_lm(scale, "scale", cuda=cuda)
    if scale.device != x.device:
        raise ValueError(f"scale lies on {scale.device}, x on {x.device}")
    raise ValueError(f"x must be (..., d) and scale (d,), got "
                     f"{tuple(x.shape)} and {tuple(scale.shape)}")


def check_rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
                  cuda: bool = True) -> None:
    """Raise, with its message, on what the kernel does not take;
    ``cuda=False`` (the op's fake rule) lets a tensor lie on any device."""
    d = x.shape[-1] if x.dim() else 0
    if not ((x.is_cuda or not cuda) and x.dtype in LM_DTYPES
            and x.is_contiguous() and scale.dtype in LM_DTYPES
            and scale.is_contiguous()
            and scale.get_device() == x.get_device() and d >= 1
            and scale.shape == (d,)):
        _refuse(x, scale, cuda)


def _mask(x: torch.Tensor, scale: torch.Tensor) -> int:
    """The ``_dt`` C entries' dtype mask: 1 where x (and its kin) is
    bfloat16, 2 where scale is; 0 (all float32) takes the float32 entry."""
    return (x.dtype is BF16) | ((scale.dtype is BF16) << 1)


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, *,
                 eps: float = 1e-6) -> torch.Tensor:
    """(..., d) rows + (d,) scale on the card, each float32 or bfloat16 ->
    (..., d) in x's type."""
    check_rmsnorm(x, scale)
    d, dev = x.shape[-1], x.get_device()
    out = torch.empty_like(x)
    n = x.numel() // d
    if n:
        lib, mask = _build.library(), _mask(x, scale)
        args = (x.data_ptr(), scale.data_ptr(), out.data_ptr(), n, d, eps)
        _build.check(lib.rt_rmsnorm_dt(*args, mask, dev, _build.stream_of(x))
                     if mask else
                     lib.rt_rmsnorm(*args, dev, _build.stream_of(x)),
                     "rmsnorm")
    return out


#: blocks of the backward, each writing one float64 row of dscale partials:
#: one a row up to this many rows, then this many. Taken from the row count
#: alone, so dscale's summation order, and its bits, are the same on any card.
PARTIALS = 256


def _refuse_bwd(x, scale, g, cuda):
    require_lm(x, "x", cuda=cuda)
    require_lm(scale, "scale", cuda=cuda)
    require_lm(g, "g", dtype=x.dtype, cuda=cuda)
    for name, t in (("scale", scale), ("g", g)):
        if t.device != x.device:
            raise ValueError(f"{name} lies on {t.device}, x on {x.device}")
    raise ValueError(f"x and g must be (..., d) and scale (d,), got "
                     f"{tuple(x.shape)}, {tuple(g.shape)} and "
                     f"{tuple(scale.shape)}")


def check_rmsnorm_bwd(x, scale, g, *, cuda: bool = True) -> None:
    """The backward kernel's refusals, as :func:`check_rmsnorm`'s; g (the
    gradient of the output) has x's type."""
    d = x.shape[-1] if x.dim() else 0
    dev = x.get_device()
    if not (all((t.is_cuda or not cuda) and t.is_contiguous()
                and t.get_device() == dev for t in (x, scale, g))
            and x.dtype in LM_DTYPES and scale.dtype in LM_DTYPES
            and g.dtype == x.dtype
            and d >= 1 and scale.shape == (d,) and g.shape == x.shape):
        _refuse_bwd(x, scale, g, cuda)


def rmsnorm_bwd_cuda(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                     *, eps: float = 1e-6):
    """Gradients of ``rmsnorm_cuda(x, scale, eps)`` for an output gradient
    ``g``: (..., d) rows x and g of one type, (d,) scale, each float32 or
    bfloat16, contiguous on one card -> (dx (..., d) in x's type, dscale
    (d,) in scale's). ``rsqrt(mean(x^2) + eps)`` is recomputed from x;
    dscale sums per-block float64 partials in a fixed order and is rounded
    once. Checked in one pass, as the forward is."""
    check_rmsnorm_bwd(x, scale, g)
    d, dev = x.shape[-1], x.get_device()
    dx = torch.empty_like(x)
    n = x.numel() // d
    if not n:
        return dx, torch.zeros_like(scale)
    nb = min(n, PARTIALS)
    part = x.new_empty((nb, d), dtype=torch.float64)
    dscale = torch.empty_like(scale)
    lib, mask = _build.library(), _mask(x, scale)
    args = (x.data_ptr(), scale.data_ptr(), g.data_ptr(), dx.data_ptr(),
            part.data_ptr(), dscale.data_ptr(), n, d, nb, eps)
    _build.check(lib.rt_rmsnorm_bwd_dt(*args, mask, dev, _build.stream_of(x))
                 if mask else
                 lib.rt_rmsnorm_bwd(*args, dev, _build.stream_of(x)),
                 "rmsnorm_bwd")
    return dx, dscale
