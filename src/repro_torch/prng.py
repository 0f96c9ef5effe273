"""``jax.random``'s threefry2x32 draws, in numpy.

The reference draws its keys, weights and traffic from ``jax.random``; a
torch generator cannot give the same numbers. This module reproduces the
default threefry2x32 implementation with ``jax_threefry_partitionable``
on (the default since JAX 0.5), without JAX:

* a key is two uint32 words; ``prng_key(seed)`` is ``[0, seed]``;
* ``split(key, n)[i]`` is ``threefry2x32(key, (0, i))``;
* ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``;
* the 32-bit ``random_bits`` at flat (row-major) index ``i`` is
  ``out0 ^ out1`` of ``threefry2x32(key, (i >> 32, i & 0xffffffff))``;
* ``uniform`` puts 23 of those bits in a float32 mantissa in [1, 2),
  subtracts 1, scales into [lo, hi) and clamps below at ``lo``;
* ``normal`` is ``sqrt(2) * erfinv(u)`` for u uniform in
  (nextafter(-1, 0), 1), with XLA's single-precision ``erfinv`` (Giles'
  polynomial) over XLA's CPU ``log1p``.

XLA's CPU backend contracts each multiply feeding an add into one fused
multiply-add; :func:`fma32` does the same here. Keys, bits and uniforms
are JAX's bit for bit; normals were too on every draw compared with JAX
0.9's CPU backend (``tests/test_torch_prng.py``), which holds them to 2
ulp, the room another ``log`` or ``sqrt`` would need.

Everything is float32 or uint32 numpy, formed in the order JAX forms it.
"""
from __future__ import annotations

import math
from typing import Tuple, Union

import numpy as np

Key = Union[int, np.integer, np.ndarray]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry2x32 (20 rounds, five key injections) of the counter words
    ``x0``, ``x1`` (scalars or uint32 arrays of one shape) under the two
    key words -> the two output words, each of the counters' shape."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, np.uint32(k0 ^ k1 ^ _PARITY))
    x = [np.array(x0, np.uint32, ndmin=1), np.array(x1, np.uint32, ndmin=1)]
    shape = np.shape(x0)
    with np.errstate(over="ignore"):      # the additions wrap mod 2**32
        x = [x[0] + ks[0], x[1] + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0].reshape(shape), x[1].reshape(shape)


def prng_key(seed: int) -> np.ndarray:
    """The key words of ``jax.random.PRNGKey(seed)`` for a seed in [0,
    2**32): ``[0, seed]``."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed must lie in [0, 2**32), got {seed}")
    return np.array([0, seed], dtype=np.uint32)


def as_key(key: Key) -> np.ndarray:
    """An int seed or a uint32[2] key -> the uint32[2] key words."""
    if isinstance(key, (int, np.integer)):
        return prng_key(int(key))
    words = np.asarray(key)
    if words.shape != (2,):
        raise ValueError(f"a key is an int seed or two uint32 words, got "
                         f"shape {words.shape}")
    return words.astype(np.uint32)


def fold_in(key: Key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: ``threefry2x32(key, (0, data))``."""
    out = threefry2x32(as_key(key), 0, int(data) & 0xFFFFFFFF)
    return np.array(out, dtype=np.uint32)


def split(key: Key, n: int = 2) -> np.ndarray:
    """``jax.random.split(key, n)``: (n, 2) key words, row i
    ``threefry2x32(key, (0, i))``."""
    out0, out1 = threefry2x32(as_key(key), np.zeros(n, np.uint32),
                              np.arange(n, dtype=np.uint32))
    return np.stack([out0, out1], axis=-1)


def random_bits(key: Key, shape=()) -> np.ndarray:
    """``jax.random.bits(key, shape, uint32)``: at flat index i, ``out0 ^
    out1`` of ``threefry2x32(key, (i >> 32, i & 0xffffffff))``."""
    shape = tuple(int(s) for s in shape)
    idx = np.arange(math.prod(shape), dtype=np.uint64)
    out0, out1 = threefry2x32(as_key(key), (idx >> np.uint64(32))
                              .astype(np.uint32), idx.astype(np.uint32))
    return (out0 ^ out1).reshape(shape)


def fma32(a, b, c) -> np.ndarray:
    """``a * b + c`` of float32 operands rounded once to float32, as XLA's
    CPU backend contracts a multiply and an add. The product is exact in
    float64 (48 bits); the float64 sum is made round-to-odd from its exact
    error, so its rounding to float32 is the correctly rounded one."""
    a, b, c = (np.asarray(t, np.float32).astype(np.float64) for t in (a, b, c))
    p = a * b
    s = p + c
    pb = s - c
    err = (p - pb) + (c - (s - pb))                 # s + err == p + c exactly
    even = (s.view(np.int64) & 1) == 0
    fix = (err != 0) & even & np.isfinite(s)
    s = np.where(fix, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def uniform(key: Key, shape=(), lo=0.0, hi=1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, lo, hi)``."""
    lo, hi = np.float32(lo), np.float32(hi)
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, fma32(floats, hi - lo, lo))


# XLA's CPU ``log1p`` (float32): a Cephes rational form below |x| < sqrt(2)
# - 1, ``log(1 + x)`` above, its ``log`` the Cephes polynomial of
# ``polynomial_approximations.cc``; every multiply-add contracted.
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
          -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
          2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)
_LOG_Q1, _LOG_Q2 = np.float32(-2.12194440e-4), np.float32(0.693359375)


def _horner(x: np.ndarray, coeffs) -> np.ndarray:
    p = np.full_like(x, np.float32(coeffs[0]))
    for c in coeffs[1:]:
        p = fma32(p, x, np.float32(c))
    return p


def _log(x: np.ndarray) -> np.ndarray:
    """XLA CPU's float32 ``log`` for positive normal x: x = m * 2**e with
    m in [sqrt(1/2), sqrt(2)), a degree-8 polynomial in m - 1."""
    f = np.float32
    bits = np.maximum(np.uint32(0x00800000).view(f), x).view(np.uint32)
    e = f(1) + ((bits >> np.uint32(23)).astype(np.int32) - 0x7F).astype(f)
    m = ((bits & np.uint32(0x807FFFFF)) | np.uint32(0x3F000000)).view(f)
    low = m < f(0.707106781186547524)
    e = e - np.where(low, f(1), f(0))
    t = (m - f(1)) + np.where(low, m, f(0))
    t2 = t * t
    t3 = t2 * t
    y = fma32(fma32(t, _LOG_P[0], _LOG_P[1]), t, _LOG_P[2])
    y1 = fma32(fma32(t, _LOG_P[3], _LOG_P[4]), t, _LOG_P[5])
    y2 = fma32(fma32(t, _LOG_P[6], _LOG_P[7]), t, _LOG_P[8])
    y = fma32(fma32(y, t3, y1), t3, y2)
    y = fma32(y, t3, _LOG_Q1 * e)
    t = fma32(f(-0.5), t2, t) + y
    return fma32(_LOG_Q2, e, t)


def log1p(x: np.ndarray) -> np.ndarray:
    """XLA CPU's float32 ``log1p`` for x in (-1, 1)."""
    f = np.float32
    x = np.asarray(x, f)
    x2 = x * x
    small = (x * x2) * (_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN))
    small = x + fma32(f(-0.5), x2, small)
    return np.where(np.abs(x) < f(0.41421356237309504880), small,
                    _log(x + f(1)))


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: np.ndarray) -> np.ndarray:
    """XLA's single-precision ``erf_inv``: with ``w = -log1p(-x*x)``, a
    degree-8 polynomial in ``w - 2.5`` for w < 5 and in ``sqrt(w) - 3``
    otherwise, times x; ``erfinv(+-1) = +-inf``."""
    x = np.asarray(x, np.float32)
    w = -log1p(x * -x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = fma32(p, w, np.where(lt, np.float32(a), np.float32(b)))
    with np.errstate(over="ignore"):
        return np.where(np.abs(x) == np.float32(1.0), x * np.float32(np.inf),
                        p * x).astype(np.float32)


def normal(key: Key, shape=()) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, np.float32(1.0))
    return np.float32(math.sqrt(2)) * erfinv(u)
