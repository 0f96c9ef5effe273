"""Fused RMSNorm: the CUDA wrapper.

Port of ``repro.kernels.rmsnorm``: ``x * rsqrt(mean(x^2) + eps) * scale``
over the last axis of ``x`` (..., d), in float32. The kernel is
``csrc/rmsnorm.cu``; its plain version is
:func:`repro_torch.kernels.ref.rmsnorm_ref`.

A decode step calls it 113 times on 8 rows, where the host's part of a call
is most of its time, so the arguments are checked in one pass and the
messages are built only for a refusal.
"""
from __future__ import annotations

import torch

from . import _build
from .pack_bits import _require_cuda


def _refuse(x: torch.Tensor, scale: torch.Tensor, d: int):
    _require_cuda(x, "x", torch.float32)
    _require_cuda(scale, "scale", torch.float32)
    if scale.device != x.device:
        raise ValueError(f"scale lies on {scale.device}, x on {x.device}")
    raise ValueError(f"x must be (..., d) and scale (d,), got "
                     f"{tuple(x.shape)} and {tuple(scale.shape)}")


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, *,
                 eps: float = 1e-6) -> torch.Tensor:
    """(..., d) float32 rows + (d,) float32 scale on the card -> (..., d)."""
    d = x.shape[-1] if x.dim() else 0
    dev = x.get_device()
    if not (x.is_cuda and x.dtype == torch.float32 and x.is_contiguous()
            and scale.dtype == torch.float32 and scale.is_contiguous()
            and scale.get_device() == dev and d >= 1
            and scale.shape == (d,)):
        _refuse(x, scale, d)
    out = torch.empty_like(x)
    n = x.numel() // d
    if n:
        _build.check(_build.library().rt_rmsnorm(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(), n, d, eps, dev,
            _build.stream_of(x)), "rmsnorm")
    return out
