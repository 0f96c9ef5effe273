"""Causal / sliding-window flash attention: the CUDA wrapper.

Port of ``repro.kernels.flash_attention``: softmax attention over
(B, T, H, D) queries, keys and values with scale ``1/sqrt(D)``, an online
softmax over KV tiles and masked scores at ``-1e30``. GQA is taken
natively: query head ``h`` reads KV head ``h // (Hq // Hkv)``, where the
reference's ``ops`` repeats k and v first. The kernel is
``csrc/flash_attention.cu`` (its two products on TF32 tensor cores, in
three passes that keep FP32 accuracy); its plain version is
:func:`repro_torch.kernels.ref.flash_attention_ref`.
"""
from __future__ import annotations

import math

import torch

from . import _build
from .pack_bits import _require_cuda

#: head dims the kernel is instantiated for (the smoke config's and qwen3's)
HEAD_DIMS = (64, 128)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """q (B, Tq, Hq, D), k and v (B, Tk, Hkv, D), float32 and contiguous on
    the card -> (B, Tq, Hq, D)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        _require_cuda(t, name, torch.float32)
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, T, H, D), got "
                             f"{tuple(t.shape)}")
    B, Tq, Hq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k and v must be (B, Tk, Hkv, D) beside q "
                         f"{tuple(q.shape)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    Tk, Hkv = k.shape[1], k.shape[2]
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not share {Hkv} KV heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got {D}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    out = torch.empty_like(q)
    if B and Tq and Hq and Tk:
        _build.check(_build.library().rt_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Tq,
            Tk, Hq, Hkv, D, int(bool(causal)), int(window),
            1.0 / math.sqrt(D), q.get_device(), _build.stream_of(q)),
            "flash_attention")
    return out
