"""Causal / sliding-window flash attention: the CUDA wrapper.

Port of ``repro.kernels.flash_attention``: softmax attention over
(B, T, H, D) queries, keys and values with scale ``1/sqrt(D)``, an online
softmax over KV tiles and masked scores at ``-1e30``. GQA is taken
natively: query head ``h`` reads KV head ``h // (Hq // Hkv)``, where the
reference's ``ops`` repeats k and v first. The kernel is
``csrc/flash_attention.cu`` (its two products on TF32 tensor cores, in
three passes that keep FP32 accuracy) on float32 or bfloat16 inputs, the
output in their type and the log-sum-exp float32; its plain version is
:func:`repro_torch.kernels.ref.flash_attention_ref`. When a graph is
built the forward also writes each row's log-sum-exp, and the backward
is ``csrc/flash_attention_bwd.cu`` (:func:`flash_attention_bwd_cuda`,
plain version :func:`repro_torch.kernels.ref.flash_attention_bwd_ref`).
"""
from __future__ import annotations

import math

import torch

from . import _build
from ._dtypes import BF16, F32, LM_DTYPES, require_lm

#: head dims the forward kernel is instantiated for: 64 and 128 (the smoke
#: configs', qwen3's and the rest), 96 and 192 (MLA's q/k widths at
#: minicpm3-4b and deepseek-v3, v padded to them) and 256 (gemma-7b); other
#: head dims up to 256 are padded to the next of these by
#: :func:`repro_torch.nn.attention.attend`
HEAD_DIMS = (64, 96, 128, 192, 256)
#: head dims the backward kernel is instantiated for: the forward's, so
#: that every head dim :func:`repro_torch.nn.attention.attend` pads to also
#: trains (past 128 ``csrc/flash_attention_bwd.cu`` takes its wide layout)
BWD_HEAD_DIMS = HEAD_DIMS


def check_flash(q, k, v, window: int, *, cuda: bool = True) -> None:
    """Raise, with its message, on what the forward kernel does not take;
    ``cuda=False`` (the op's fake rule) lets the tensors lie on any
    device."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        require_lm(t, name, dtype=None if name == "q" else q.dtype,
                   cuda=cuda)
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, T, H, D), got "
                             f"{tuple(t.shape)}")
    B, Tq, Hq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k and v must be (B, Tk, Hkv, D) beside q "
                         f"{tuple(q.shape)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    Hkv = k.shape[2]
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not share {Hkv} KV heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got {D}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         return_lse: bool = False):
    """q (B, Tq, Hq, D), k and v (B, Tk, Hkv, D), of one type (float32 or
    bfloat16) and contiguous on the card -> (B, Tq, Hq, D) in that type;
    with ``return_lse`` also the (B, Hq, Tq) float32 log-sum-exp of each
    row's scaled, masked scores (the output is the same bits either
    way)."""
    check_flash(q, k, v, window)
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = q.new_empty((B, Hq, Tq), dtype=F32) if return_lse else None
    if B and Tq and Hq and Tk:
        lib, tail = _build.library(), (q.get_device(), _build.stream_of(q))
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), B, Tq, Tk, Hq, Hkv,
                D, int(bool(causal)), int(window), 1.0 / math.sqrt(D))
        _build.check(lib.rt_flash_attention_dt(*args, 1, *tail)
                     if q.dtype is BF16 else
                     lib.rt_flash_attention(*args, *tail), "flash_attention")
    return (out, lse) if return_lse else out


#: the backward's device scratch, at most (or one 128-row range's, if more)
SCRATCH_BYTES = 288 << 20
_DQ_ROWS = 128                           # the dQ kernel's rows a block


def _ds_blocks(qb0: int, qb1: int, nbk: int, causal: bool) -> int:
    """The backward's 16 x 16 dS blocks of query blocks [qb0, qb1) of one
    (b, query head), nbk key blocks: those a query can see, when causal
    the lower triangle, query block qb holding min(qb + 1, nbk) of them
    (``csrc/flash_attention_bwd.cu::ds_rows``)."""
    if not causal:
        return (qb1 - qb0) * nbk

    def before(qb):                      # the blocks of query blocks < qb
        if qb <= nbk:
            return qb * (qb + 1) // 2
        return nbk * (nbk + 1) // 2 + (qb - nbk) * nbk

    return before(qb1) - before(qb0)


def bwd_plan(B: int, Tq: int, Tk: int, Hq: int, causal: bool):
    """How the backward keeps its scratch within :data:`SCRATCH_BYTES`:
    (batch elements a launch, the query row ranges each batch slice takes
    in turn, the scratch's floats), for Tq queries over Tk keys. The
    scratch holds each query row's delta = <do, o>, rounded up to 4
    floats, then the launch's dS in 16 x 16 blocks of 256 floats. The
    whole batch in one launch where it fits (273.2 MB at qwen3's training
    shape, 147.9 MB at whisper-base's cross-attention); else as many batch
    elements a launch as fit (whisper-base's encoder: 4 of 8); else one a
    launch over ranges of whole 128-row groups, each range as long as fits,
    at least one group (a causal group of 128 rows over T keys takes Hq *
    T / 2 KB: 268 MB at 16 heads and T = 32,768)."""
    nbk = -(-Tk // 16)

    def floats(bc, r0, r1):
        return (-(-bc * Hq * Tq // 4) * 4
                + bc * Hq * 256 * _ds_blocks(r0 // 16, -(-r1 // 16), nbk,
                                             causal))

    budget = SCRATCH_BYTES // 4
    if floats(B, 0, Tq) <= budget:
        return B, [(0, Tq)], floats(B, 0, Tq)
    whole = floats(1, 0, Tq)
    if whole <= budget:
        bc = budget // whole
        return bc, [(0, Tq)], floats(bc, 0, Tq)
    bounds, r0 = [], 0
    while r0 < Tq:
        r1 = min(Tq, r0 + _DQ_ROWS)
        while r1 < Tq and floats(1, r0, min(Tq, r1 + _DQ_ROWS)) <= budget:
            r1 = min(Tq, r1 + _DQ_ROWS)
        bounds.append((r0, r1))
        r0 = r1
    return 1, bounds, max(floats(1, r0, r1) for r0, r1 in bounds)


def _refuse_bwd(q, k, v, o, lse, do, window, cuda):
    """Raise, with its message, for the first argument the backward kernel
    does not take."""
    named = (("q", q), ("k", k), ("v", v), ("o", o), ("lse", lse),
             ("do", do))
    for name, t in named:
        require_lm(t, name, dtype=(None if name == "q" else F32
                                   if name == "lse" else q.dtype),
                   cuda=cuda)
        if t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, Tq, H, D), got {tuple(q.shape)}")
    B, Tq, Hq, D = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o and do must have q's shape {tuple(q.shape)}, "
                         f"got {tuple(o.shape)} and {tuple(do.shape)}")
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != D:
        raise ValueError(f"k and v must be (B, Tk, Hkv, D) beside q "
                         f"{tuple(q.shape)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    Hkv = k.shape[2]
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not share {Hkv} KV heads")
    if lse.shape != (B, Hq, Tq):
        raise ValueError(f"lse must be (B, Hq, Tq) = {(B, Hq, Tq)}, got "
                         f"{tuple(lse.shape)}")
    if D not in BWD_HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {BWD_HEAD_DIMS}, got "
                         f"{D}")
    raise ValueError(f"window must be >= 0, got {window}")


def check_flash_bwd(q, k, v, o, lse, do, window: int, *,
                    cuda: bool = True) -> None:
    """The backward kernel's refusals in one pass, the messages built
    only for a refusal; ``cuda=False`` as :func:`check_flash`'s."""
    dev = q.get_device()
    ok = q.dim() == 4 and k.dim() == 4 and window >= 0
    if ok:
        B, Tq, Hq, D = q.shape
        Hkv = k.shape[2]
        ok = (all((t.is_cuda or not cuda) and t.is_contiguous()
                  and t.get_device() == dev for t in (q, k, v, o, lse, do))
              and q.dtype in LM_DTYPES and lse.dtype == F32
              and k.dtype == v.dtype == o.dtype == do.dtype == q.dtype
              and o.shape == q.shape and do.shape == q.shape
              and k.shape == v.shape and k.shape[0] == B
              and k.shape[3] == D and Hkv >= 1 and Hq % Hkv == 0
              and lse.shape == (B, Hq, Tq) and D in BWD_HEAD_DIMS)
    if not ok:
        _refuse_bwd(q, k, v, o, lse, do, window, cuda)


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True, window: int = 0):
    """Gradients of the forward at (q, k, v): q, o and its gradient ``do``
    (B, Tq, Hq, D), k and v (B, Tk, Hkv, D), the forward's ``lse`` (B, Hq,
    Tq) float32, the rest of one type (float32 or bfloat16), contiguous on
    one card -> (dq, dk, dv) in the shapes and type of q, k and v, each
    accumulated in float32 and rounded once. At bfloat16 a call over more
    than one range of query rows, or with rows that see no key, keeps the
    sums that wait between launches in float32 buffers of k's shape
    (``dk32``, ``dv32``), freed on return. The mask is the forward's at
    any Tq and Tk (``causal``
    and ``window`` count positions from 0 on both sides). Each KV head's
    gradient sums its query heads' in a fixed order: the same bits run to
    run. The
    kernels pass dS from the dK/dV kernel to the dQ kernel through a
    scratch of at most :data:`SCRATCH_BYTES` (or one 128-row range's),
    freed on return: past it the call launches the kernels on slices of
    the batch, or over ranges of query rows, as :func:`bwd_plan` says. The
    arguments are checked in one pass; the messages are built only for a
    refusal (_refuse_bwd)."""
    check_flash_bwd(q, k, v, o, lse, do, window)
    dev = q.get_device()
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    if not (B and Tq and Tk and Hq):     # no query sees a key
        return dq.zero_(), dk.zero_(), dv.zero_()
    bc, bounds, floats = bwd_plan(B, Tq, Tk, Hq, bool(causal))
    scratch = lse.new_empty(floats)
    bf16 = q.dtype is BF16
    blind = window > 0 and Tk - 1 + window < Tq
    dk32 = dk.new_empty(dk.shape, dtype=F32) \
        if bf16 and len(bounds) > 1 else None
    dv32 = dv.new_empty(dv.shape, dtype=F32) \
        if bf16 and (len(bounds) > 1 or blind) else None
    # float32: the float32 entry (dk and dv hold the sums between launches)
    lib, stream = _build.library(), _build.stream_of(q)
    fn = lib.rt_flash_attention_bwd_dt if bf16 else lib.rt_flash_attention_bwd
    tensors = (q, k, v, o, lse, do, dq, dk, dv) + ((dk32, dv32) if bf16
                                                   else ())
    for b0 in range(0, B, bc):
        n = min(bc, B - b0)
        # the slice's first bytes of each (B, ...) tensor (null: no buffer)
        at = [t.data_ptr() + b0 * (t.numel() // B) * t.element_size()
              if t is not None else None for t in tensors]
        for r0, r1 in bounds:
            _build.check(fn(
                *at[:6], scratch.data_ptr(), floats, *at[6:], n, Tq, Tk, Hq,
                Hkv, D, int(bool(causal)), int(window), 1.0 / math.sqrt(D),
                r0, r1, *((1,) if bf16 else ()), dev, stream),
                "flash_attention_bwd")
    return dq, dk, dv
