"""Fused RMSNorm: the CUDA wrapper.

Port of ``repro.kernels.rmsnorm``: ``x * rsqrt(mean(x^2) + eps) * scale``
over the last axis of ``x`` (..., d), in float32. The kernel is
``csrc/rmsnorm.cu``; its plain version is
:func:`repro_torch.kernels.ref.rmsnorm_ref`.
"""
from __future__ import annotations

import torch

from . import _build
from .pack_bits import _require_cuda


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, *,
                 eps: float = 1e-6) -> torch.Tensor:
    """(..., d) float32 rows + (d,) float32 scale on the card -> (..., d)."""
    _require_cuda(x, "x", torch.float32)
    _require_cuda(scale, "scale", torch.float32)
    d = x.shape[-1] if x.dim() else 0
    if d < 1 or tuple(scale.shape) != (d,):
        raise ValueError(f"x must be (..., d) and scale (d,), got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    out = torch.empty_like(x)
    n = x.numel() // d
    if n:
        _build.check(_build.library().rt_rmsnorm(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(), n, d, eps,
            x.device.index, _build.stream_of(x)), "rmsnorm")
    return out
