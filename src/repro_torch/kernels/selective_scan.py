"""Selective scan (the Mamba recurrence and its output): the CUDA wrapper.

Port of ``repro.kernels.selective_scan``::

    h_t = decay_t * h_{t-1} + inp_t          (B, T, di, N)
    y_t = <h_t, C_t>_N                        -> (B, T, di)

returning ``(y, h_last)``, float32, from decay, inp, c and h0 each float32
or bfloat16 (as the TPU kernel). The kernel is ``csrc/selective_scan.cu``; its
plain version is :func:`repro_torch.kernels.ref.selective_scan_ref`. The
kernel keeps each channel's state in registers, so it takes N <= 16
(Mamba's and Jamba's ``d_state`` is 16). Its backward is
``csrc/selective_scan_bwd.cu`` (:func:`selective_scan_bwd_cuda`, plain
version :func:`repro_torch.kernels.ref.selective_scan_bwd_ref`), which
takes the same arguments.
"""
from __future__ import annotations

import torch

from . import _build
from ._dtypes import BF16, F32, LM_DTYPES

#: the most states a channel may carry (the kernel holds them in registers)
MAX_STATE = 16
#: the backward's (channel, state) threads a block, and its checkpointed
#: chunk's steps (``csrc/selective_scan_bwd.cu``: kThreads, kL)
BWD_THREADS, BWD_CHUNK = 256, 16


def check_scan_args(decay: torch.Tensor, inp: torch.Tensor, c: torch.Tensor,
                    h0: torch.Tensor) -> None:
    """Raise unless decay and inp are (B, T, di, N), c (B, T, N) and h0
    (B, di, N), each float32 or bfloat16, contiguous and on one device,
    with T >= 1.
    The common case is checked in one pass (a decode step calls this once a
    Mamba layer); the messages are built only for a refusal."""
    s, ok, dev = decay.shape, LM_DTYPES, decay.get_device()
    if (len(s) == 4 and s[1] >= 1 and inp.shape == s
            and c.shape == (s[0], s[1], s[3])
            and h0.shape == (s[0], s[2], s[3])
            and decay.dtype in ok and inp.dtype in ok and c.dtype in ok
            and h0.dtype in ok and decay.is_contiguous()
            and inp.is_contiguous() and c.is_contiguous()
            and h0.is_contiguous() and inp.get_device() == dev
            and c.get_device() == dev and h0.get_device() == dev):
        return
    if decay.dim() != 4 or inp.shape != decay.shape:
        raise ValueError(f"decay and inp must be one (B, T, di, N) shape, "
                         f"got {tuple(decay.shape)} and {tuple(inp.shape)}")
    B, T, di, N = decay.shape
    if tuple(c.shape) != (B, T, N) or tuple(h0.shape) != (B, di, N):
        raise ValueError(f"c must be (B, T, N) = {(B, T, N)} and h0 (B, di, "
                         f"N) = {(B, di, N)}, got {tuple(c.shape)} and "
                         f"{tuple(h0.shape)}")
    if T < 1:
        raise ValueError("the scan needs at least one time step")
    for name, t in (("decay", decay), ("inp", inp), ("c", c), ("h0", h0)):
        if t.dtype not in LM_DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != decay.device:
            raise ValueError(f"{name} lies on {t.device}, decay on "
                             f"{decay.device}: all four must share a device")


def check_scan_kernel(decay, inp, c, h0, *, cuda: bool = True) -> None:
    """The kernels' refusals: :func:`check_scan_args`, then the card (where
    ``cuda``; ``cuda=False`` is the op's fake rule, which takes a tensor on
    any device), N <= :data:`MAX_STATE` and B <= 65,535."""
    check_scan_args(decay, inp, c, h0)
    if cuda and not decay.is_cuda:
        raise ValueError(f"decay must lie on a CUDA device, got "
                         f"{decay.device}")
    B, T, di, N = decay.shape
    if N > MAX_STATE or B > 65535:
        raise ValueError(f"the kernel takes N <= {MAX_STATE} states and "
                         f"B <= 65,535, got N {N} and B {B}")


def check_scan_bwd_kernel(decay, inp, c, h0, gy, gh, *,
                          cuda: bool = True) -> None:
    """The backward kernel's refusals: :func:`check_scan_kernel`'s, then
    gy (B, T, di) and gh (B, di, N), float32 and contiguous beside
    decay."""
    check_scan_kernel(decay, inp, c, h0, cuda=cuda)
    B, T, di, N = decay.shape
    for name, t, shape in (("gy", gy, (B, T, di)), ("gh", gh, (B, di, N))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != decay.device:
            raise ValueError(f"{name} lies on {t.device}, decay on "
                             f"{decay.device}")


def _mask(decay, inp, c, h0) -> int:
    """The ``_dt`` C entries' dtype mask: 1, 2, 4, 8 where decay, inp, c,
    h0 is bfloat16; 0 (all float32) takes the float32 entry."""
    return ((decay.dtype is BF16) | ((inp.dtype is BF16) << 1)
            | ((c.dtype is BF16) << 2) | ((h0.dtype is BF16) << 3))


def selective_scan_cuda(decay: torch.Tensor, inp: torch.Tensor,
                        c: torch.Tensor, h0: torch.Tensor):
    """decay, inp (B, T, di, N), c (B, T, N), h0 (B, di, N), each float32
    or bfloat16, on the card -> (y (B, T, di), h_last (B, di, N)),
    float32."""
    check_scan_kernel(decay, inp, c, h0)
    B, T, di, N = decay.shape
    y = decay.new_empty((B, T, di), dtype=F32)
    h_last = torch.empty_like(h0, dtype=F32)
    if di:
        lib, mask = _build.library(), _mask(decay, inp, c, h0)
        args = (decay.data_ptr(), inp.data_ptr(), c.data_ptr(),
                h0.data_ptr(), y.data_ptr(), h_last.data_ptr(), B, T, di, N)
        tail = (decay.get_device(), _build.stream_of(decay))
        _build.check(lib.rt_selective_scan_dt(*args, mask, *tail) if mask
                     else lib.rt_selective_scan(*args, *tail),
                     "selective_scan")
    return y, h_last


def bwd_scratch(B: int, T: int, di: int, N: int):
    """The backward's two scratch buffers, in floats: the state at the
    start of every 16-step chunk (B, ceil(T / 16), di, N), and each channel
    block's part of dc (B, blocks, T, N), ``256 // N`` channels a block."""
    blocks = -(-di // (BWD_THREADS // N))
    return B * -(-T // BWD_CHUNK) * di * N, B * blocks * T * N


def selective_scan_bwd_cuda(decay: torch.Tensor, inp: torch.Tensor,
                            c: torch.Tensor, h0: torch.Tensor,
                            gy: torch.Tensor, gh: torch.Tensor):
    """Gradients of :func:`selective_scan_cuda` at (decay, inp, c, h0) for
    the output gradients ``gy`` (B, T, di) of y and ``gh`` (B, di, N) of
    h_last, float32 and contiguous on the card -> (d_decay, d_inp, dc,
    dh0) in the shapes and types of decay, inp, c and h0 (each rounded
    once from float32). dc sums over the channels in a fixed order (no
    atomics): the same bits run to run. The scratch
    (:func:`bwd_scratch`: 67 MB of checkpoints and 67 MB of partials at
    Jamba's (2, 1,024, 8,192, 16)) is freed on return."""
    check_scan_bwd_kernel(decay, inp, c, h0, gy, gh)
    B, T, di, N = decay.shape
    d_decay, d_inp = torch.empty_like(decay), torch.empty_like(inp)
    dc, dh0 = torch.empty_like(c), torch.empty_like(h0)
    if not di:
        return d_decay, d_inp, dc.zero_(), dh0
    ckpt, part = (decay.new_empty(n, dtype=F32)
                  for n in bwd_scratch(B, T, di, N))
    lib, mask = _build.library(), _mask(decay, inp, c, h0)
    args = (decay.data_ptr(), inp.data_ptr(), c.data_ptr(), h0.data_ptr(),
            gy.data_ptr(), gh.data_ptr(), d_decay.data_ptr(),
            d_inp.data_ptr(), dc.data_ptr(), dh0.data_ptr(), ckpt.data_ptr(),
            part.data_ptr(), B, T, di, N)
    tail = (decay.get_device(), _build.stream_of(decay))
    _build.check(lib.rt_selective_scan_bwd_dt(*args, mask, *tail) if mask
                 else lib.rt_selective_scan_bwd(*args, *tail),
                 "selective_scan_bwd")
    return d_decay, d_inp, dc, dh0
