"""Selective scan (the Mamba recurrence and its output): the CUDA wrapper.

Port of ``repro.kernels.selective_scan``::

    h_t = decay_t * h_{t-1} + inp_t          (B, T, di, N)
    y_t = <h_t, C_t>_N                        -> (B, T, di)

returning ``(y, h_last)``. The kernel is ``csrc/selective_scan.cu``; its
plain version is :func:`repro_torch.kernels.ref.selective_scan_ref`. The
kernel keeps each channel's state in registers, so it takes N <= 16
(Mamba's and Jamba's ``d_state`` is 16).
"""
from __future__ import annotations

import torch

from . import _build

#: the most states a channel may carry (the kernel holds them in registers)
MAX_STATE = 16


def check_scan_args(decay: torch.Tensor, inp: torch.Tensor, c: torch.Tensor,
                    h0: torch.Tensor) -> None:
    """Raise unless decay and inp are (B, T, di, N), c (B, T, N) and h0
    (B, di, N), float32, contiguous and on one device, with T >= 1.
    The common case is checked in one pass (a decode step calls this once a
    Mamba layer); the messages are built only for a refusal."""
    s, f, dev = decay.shape, torch.float32, decay.get_device()
    if (len(s) == 4 and s[1] >= 1 and inp.shape == s
            and c.shape == (s[0], s[1], s[3])
            and h0.shape == (s[0], s[2], s[3])
            and decay.dtype == f and inp.dtype == f and c.dtype == f
            and h0.dtype == f and decay.is_contiguous()
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
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != decay.device:
            raise ValueError(f"{name} lies on {t.device}, decay on "
                             f"{decay.device}: all four must share a device")


def selective_scan_cuda(decay: torch.Tensor, inp: torch.Tensor,
                        c: torch.Tensor, h0: torch.Tensor):
    """decay, inp (B, T, di, N), c (B, T, N), h0 (B, di, N) float32 on the
    card -> (y (B, T, di), h_last (B, di, N))."""
    check_scan_args(decay, inp, c, h0)
    if not decay.is_cuda:
        raise ValueError(f"decay must lie on a CUDA device, got "
                         f"{decay.device}")
    B, T, di, N = decay.shape
    if N > MAX_STATE or B > 65535:
        raise ValueError(f"the kernel takes N <= {MAX_STATE} states and "
                         f"B <= 65,535, got N {N} and B {B}")
    y = decay.new_empty((B, T, di))
    h_last = torch.empty_like(h0)
    if di:
        _build.check(_build.library().rt_selective_scan(
            decay.data_ptr(), inp.data_ptr(), c.data_ptr(), h0.data_ptr(),
            y.data_ptr(), h_last.data_ptr(), B, T, di, N,
            decay.get_device(), _build.stream_of(decay)), "selective_scan")
    return y, h_last
