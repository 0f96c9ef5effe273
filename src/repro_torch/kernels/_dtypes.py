"""The element types the LM kernels take, and their refusals.

The TPU kernels (``repro.kernels.rmsnorm``, ``flash_attention``,
``selective_scan``) load float32 or bfloat16, compute in float32 and store
in the output's type; the port's kernels take the same two. float16 is
refused, with a message that names it (ROADMAP lists it as open).
"""
from __future__ import annotations

import torch

F32, BF16 = torch.float32, torch.bfloat16
#: the input types of the LM kernels and their backwards
LM_DTYPES = (F32, BF16)


def require_lm(t: torch.Tensor, name: str, *, dtype=None,
               cuda: bool = True) -> None:
    """Raise unless ``t`` lies on the card (where ``cuda``), is float32 or
    bfloat16 (``dtype`` itself where given: an argument that must share
    another's type) and is contiguous."""
    if cuda and t.device.type != "cuda":
        raise ValueError(f"{name} must lie on a CUDA device, got {t.device}")
    if dtype is not None:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    elif t.dtype not in LM_DTYPES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
