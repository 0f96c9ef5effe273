"""Causal / sliding-window flash attention: the CUDA wrapper.

Port of ``repro.kernels.flash_attention``: softmax attention over
(B, T, H, D) queries, keys and values with scale ``1/sqrt(D)``, an online
softmax over KV tiles and masked scores at ``-1e30``. GQA is taken
natively: query head ``h`` reads KV head ``h // (Hq // Hkv)``, where the
reference's ``ops`` repeats k and v first. The kernel is
``csrc/flash_attention.cu`` (its two products on TF32 tensor cores, in
three passes that keep FP32 accuracy); its plain version is
:func:`repro_torch.kernels.ref.flash_attention_ref`. When a graph is
built the forward also writes each row's log-sum-exp, and the backward
is ``csrc/flash_attention_bwd.cu`` (:func:`flash_attention_bwd_cuda`,
plain version :func:`repro_torch.kernels.ref.flash_attention_bwd_ref`).
"""
from __future__ import annotations

import math

import torch

from . import _build
from .pack_bits import _require_cuda

#: head dims the kernel is instantiated for (the smoke config's and qwen3's)
HEAD_DIMS = (64, 128)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         return_lse: bool = False):
    """q (B, Tq, Hq, D), k and v (B, Tk, Hkv, D), float32 and contiguous on
    the card -> (B, Tq, Hq, D); with ``return_lse`` also the (B, Hq, Tq)
    log-sum-exp of each row's scaled, masked scores (the output is the same
    bits either way)."""
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
    lse = q.new_empty((B, Hq, Tq)) if return_lse else None
    if B and Tq and Hq and Tk:
        _build.check(_build.library().rt_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, Tq, Tk, Hq, Hkv, D,
            int(bool(causal)), int(window), 1.0 / math.sqrt(D),
            q.get_device(), _build.stream_of(q)), "flash_attention")
    return (out, lse) if return_lse else out


def _refuse_bwd(q, k, v, o, lse, do, window):
    """Raise, with its message, for the first argument the backward kernel
    does not take."""
    named = (("q", q), ("k", k), ("v", v), ("o", o), ("lse", lse),
             ("do", do))
    for name, t in named:
        _require_cuda(t, name, torch.float32)
        if t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, T, H, D), got {tuple(q.shape)}")
    B, T, Hq, D = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o and do must have q's shape {tuple(q.shape)}, "
                         f"got {tuple(o.shape)} and {tuple(do.shape)}")
    if k.dim() != 4 or k.shape != v.shape or k.shape[:2] != (B, T) \
            or k.shape[3] != D:
        raise ValueError(f"k and v must be (B, T, Hkv, D) beside q "
                         f"{tuple(q.shape)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    Hkv = k.shape[2]
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not share {Hkv} KV heads")
    if lse.shape != (B, Hq, T):
        raise ValueError(f"lse must be (B, Hq, T) = {(B, Hq, T)}, got "
                         f"{tuple(lse.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got {D}")
    raise ValueError(f"window must be >= 0, got {window}")


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True, window: int = 0):
    """Gradients of the forward at (q, k, v): q, o and its gradient ``do``
    (B, T, Hq, D), k and v (B, T, Hkv, D), the forward's ``lse`` (B, Hq,
    T), float32 and contiguous on one card -> (dq, dk, dv) in the shapes
    of q, k and v. Queries and keys share T. Each KV head's gradient sums
    its query heads' in a fixed order: the same bits run to run. The
    arguments are checked in one pass; the messages are built only for a
    refusal (_refuse_bwd)."""
    dev = q.get_device()
    ok = q.dim() == 4 and k.dim() == 4 and window >= 0
    if ok:
        B, T, Hq, D = q.shape
        Hkv = k.shape[2]
        ok = (all(t.is_cuda and t.dtype == torch.float32
                  and t.is_contiguous() and t.get_device() == dev
                  for t in (q, k, v, o, lse, do))
              and o.shape == q.shape and do.shape == q.shape
              and k.shape == v.shape and k.shape[:2] == (B, T)
              and k.shape[3] == D and Hkv >= 1 and Hq % Hkv == 0
              and lse.shape == (B, Hq, T) and D in HEAD_DIMS)
    if not ok:
        _refuse_bwd(q, k, v, o, lse, do, window)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    if B and T and Hq:
        delta = torch.empty_like(lse)        # scratch: <do, o> a row
        _build.check(_build.library().rt_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, T, Hq, Hkv, D,
            int(bool(causal)), int(window), 1.0 / math.sqrt(D), dev,
            _build.stream_of(q)), "flash_attention_bwd")
    return dq, dk, dv
