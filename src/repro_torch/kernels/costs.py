"""The work of each LM kernel at the shapes it is given: FLOPs and bytes.

These are the counts behind the bound columns of ``PERF.md`` §6 and the
FLOP formulas that :mod:`.ops` registers with ``torch.utils.flop_counter``
for its ``torch.library`` ops, so that a step's counted work is the same
whatever implements an op (the kernel, its plain version or a fake rule).

* flash forward: ``2 * (Dqk + Dv)`` FLOP a visible (query, key) pair, a
  pair of each (batch, query head); the kernel takes q, k and v at one
  width D (``nn.attention.attend`` pads), so ``4 D``;
* flash backward: its five products, ``5 * 2 * D`` a visible pair;
* visible pairs follow the kernels' mask at any Tq and Tk: key ``kpos``
  is seen by query ``qpos`` where ``kpos < Tk``, ``kpos <= qpos``
  (causal) and ``kpos > qpos - window`` (window > 0);
* rmsnorm, the scan and their backwards: their elementwise FLOPs;
* bytes: each input read once and each output written once, each at its
  own element size: the ``*_bytes`` functions take the inputs' sizes in
  bytes (4 by default, float32; 2 for bfloat16), outputs at their inputs'
  sizes, and the float32 ones (flash's log-sum-exp, the scan's y, h_last
  and its output gradients) at 4.
"""
from __future__ import annotations

import functools
import math

import numpy as np

F32 = 4


@functools.lru_cache(maxsize=4096)
def visible_pairs(Tq: int, Tk: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the mask lets through, for one (batch, query
    head)."""
    if Tq <= 0 or Tk <= 0:
        return 0
    qpos = np.arange(Tq, dtype=np.int64)
    hi = np.minimum(qpos, Tk - 1) if causal else np.full(Tq, Tk - 1)
    lo = np.maximum(qpos - window + 1, 0) if window > 0 else np.zeros(Tq)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def _numel(shape) -> int:
    return math.prod(int(s) for s in shape)


def flash_pairs(q_shape, k_shape, causal: bool, window: int) -> int:
    """Visible pairs of a call, over every (batch, query head)."""
    B, Tq, Hq, _ = q_shape
    return B * Hq * visible_pairs(int(Tq), int(k_shape[1]), bool(causal),
                                  int(window))


def flash_flops(q_shape, k_shape, v_shape, causal, window) -> int:
    return 2 * (int(q_shape[-1]) + int(v_shape[-1])) * flash_pairs(
        q_shape, k_shape, causal, window)


def flash_bytes(q_shape, k_shape, v_shape, size: int = F32) -> int:
    """q, k, v read and out (q's shape) written at ``size`` bytes an
    element; lse (B, Hq, Tq) written in float32."""
    B, Tq, Hq, _ = q_shape
    return (size * (2 * _numel(q_shape) + _numel(k_shape) + _numel(v_shape))
            + F32 * B * Hq * Tq)


def flash_bwd_flops(q_shape, k_shape, causal, window) -> int:
    return 5 * 2 * int(q_shape[-1]) * flash_pairs(q_shape, k_shape, causal,
                                                  window)


def flash_bwd_bytes(q_shape, k_shape, size: int = F32) -> int:
    """q, k, v, o, lse, do read; dq, dk, dv written: the q- and k-shaped
    terms at ``size`` bytes an element, lse in float32."""
    B, Tq, Hq, _ = q_shape
    return (size * (5 * _numel(q_shape) + 4 * _numel(k_shape))
            + F32 * B * Hq * Tq)


def rmsnorm_flops(x_shape) -> int:
    """x^2, its sum, and two products an element."""
    return 4 * _numel(x_shape)


def rmsnorm_bytes(x_shape, x_size: int = F32, s_size: int = F32) -> int:
    """x read and out written at x's size, scale read at its own."""
    return x_size * 2 * _numel(x_shape) + s_size * int(x_shape[-1])


def rmsnorm_bwd_flops(x_shape) -> int:
    """g*scale, <g*scale, x>, dx's three operations and dscale's two, an
    element."""
    return 8 * _numel(x_shape)


def rmsnorm_bwd_bytes(x_shape, x_size: int = F32, s_size: int = F32) -> int:
    """x, g, scale read; dx, dscale written: x, g and dx at x's size,
    scale and dscale at scale's."""
    return x_size * 3 * _numel(x_shape) + s_size * 2 * int(x_shape[-1])


def scan_flops(decay_shape) -> int:
    """``decay * h + inp`` and ``<h, c>``: 4 an element of (B, T, di,
    N)."""
    return 4 * _numel(decay_shape)


def scan_bytes(decay_shape, sizes=(F32, F32, F32, F32)) -> int:
    """decay, inp, c, h0 read at their ``sizes``; y, h_last written in
    float32."""
    B, T, di, N = (int(s) for s in decay_shape)
    sd, si, sc, sh = sizes
    return ((sd + si) * B * T * di * N + sc * B * T * N + sh * B * di * N
            + F32 * (B * di * N + B * T * di))


def scan_bwd_flops(decay_shape) -> int:
    """The recomputed state (2), g (3), d_decay (1) and dc (2) an
    element."""
    return 8 * _numel(decay_shape)


def scan_bwd_bytes(decay_shape, sizes=(F32, F32, F32, F32)) -> int:
    """decay, inp, c, h0 read and their gradients written at their
    ``sizes``; gy, gh read in float32."""
    B, T, di, N = (int(s) for s in decay_shape)
    sd, si, sc, sh = sizes
    return (2 * ((sd + si) * B * T * di * N + sc * B * T * N
                 + sh * B * di * N) + F32 * (B * di * N + B * T * di))
