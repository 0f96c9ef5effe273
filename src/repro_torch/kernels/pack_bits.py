"""Dense bit-packing of VQ code indices (§2.8): layout and CUDA wrappers.

Port of ``repro.kernels.pack_bits``. Codes are packed in super-groups of
``G = lcm(b, 32) / b`` codes spanning ``W = lcm(b, 32) / 32`` words; code
``j`` of a group sits at bit ``j*b`` and may straddle two words. The
stream is zero-padded to whole groups.

Words are held as ``torch.int32`` tensors that carry the uint32 bit
pattern: PyTorch has no uint32 shifts on the CPU, and an int32 tensor
keeps ``nbytes == numel * 4``. The CUDA kernels (``csrc/pack_bits.cu``)
read and write the same bytes as ``uint32_t``. The plain versions live
in :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import math

import torch

from . import _build


def code_bits(n_atoms: int) -> int:
    """Bits per transmitted code index: ceil(log2 K) (§2.8)."""
    return max(1, math.ceil(math.log2(max(int(n_atoms), 2))))


def packing_dims(bits: int):
    """(G codes, W words) per super-group: lcm(bits, 32) bits of payload."""
    if not 1 <= bits <= 32:
        raise ValueError(f"bits must be in [1, 32], got {bits}")
    lcm = bits * 32 // math.gcd(bits, 32)
    return lcm // bits, lcm // 32


def _require_cuda(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must lie on a CUDA device, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def pack_codes_cuda(codes: torch.Tensor, *, bits: int) -> torch.Tensor:
    """int32 codes (any shape, on the card) -> (ceil(N/G), W) int32 words."""
    G, W = packing_dims(bits)
    codes = codes.reshape(-1)
    _require_cuda(codes, "codes", torch.int32)
    n = -(-codes.numel() // G)
    words = torch.empty((n, W), dtype=torch.int32, device=codes.device)
    if n:
        _build.check(_build.library().rt_pack_codes(
            codes.data_ptr(), codes.numel(), words.data_ptr(), n, bits,
            codes.get_device(), _build.stream_of(codes)), "pack_codes")
    return words


def unpack_codes_cuda(words: torch.Tensor, *, bits: int,
                      count: int) -> torch.Tensor:
    """(n, W) int32 words on the card -> (count,) int32 codes."""
    G, W = packing_dims(bits)
    _require_cuda(words, "words", torch.int32)
    if words.dim() != 2 or words.shape[1] != W:
        raise ValueError(f"words must be (n, {W}) for {bits} bits, got "
                         f"{tuple(words.shape)}")
    n = words.shape[0]
    if not 0 <= count <= n * G:
        raise ValueError(f"count {count} exceeds the {n * G} codes of the "
                         f"stream")
    codes = torch.empty((count,), dtype=torch.int32, device=words.device)
    if count:
        _build.check(_build.library().rt_unpack_codes(
            words.data_ptr(), n, codes.data_ptr(), count, bits,
            words.get_device(), _build.stream_of(words)), "unpack_codes")
    return codes
