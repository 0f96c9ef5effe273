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

At the serving path's shape the host's part is most of a call, so the CUDA
wrappers check their arguments in one test, look the layout up in a table,
and build an error message only for a refusal.
"""
from __future__ import annotations

import math

import torch

from . import _build


def code_bits(n_atoms: int) -> int:
    """Bits per transmitted code index: ceil(log2 K) (§2.8)."""
    return max(1, math.ceil(math.log2(max(int(n_atoms), 2))))


#: (G, W) for each width 1..32, looked up on every launch
_DIMS = (None,) + tuple((32 // math.gcd(b, 32), b // math.gcd(b, 32))
                        for b in range(1, 33))
#: codes a chunk of the CUDA kernels: 128 codes fill 4b words at any width
CHUNK = 128
#: warps a block of the CUDA kernels, and the chunks a warp takes where
#: blocks of such groups still give every SM one (else it takes one chunk)
WARPS, GROUP = 4, 4


def packing_dims(bits: int):
    """(G codes, W words) per super-group: lcm(bits, 32) bits of payload."""
    if not 1 <= bits <= 32:
        raise ValueError(f"bits must be in [1, 32], got {bits}")
    return _DIMS[bits]


def kernel_path(bits: int, count: int, *tensors: torch.Tensor,
                sms: int) -> str:
    """The path the CUDA kernels take for a stream of ``count`` codes
    between ``tensors`` on a card of ``sms`` SMs: "copy" at 32 bits, else
    "chunks" (16-byte vectors on both sides); "x4" where a warp takes GROUP
    consecutive chunks (the stream gives every SM a block of them), "x1"
    where it takes one; "+tail" where the last chunk is partial (its lanes
    past the end go element by element); "+masked" where a pointer is off
    16-byte alignment (every access element by element)."""
    chunks = -(-count // CHUNK)
    grouped = -(-chunks // (WARPS * GROUP)) >= sms
    path = ("copy" if bits == 32 else "chunks") + ("x4" if grouped else "x1")
    if any(t.data_ptr() % 16 for t in tensors):
        return path + "+masked"
    return path + ("+tail" if count % CHUNK else "")


def _require_cuda(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must lie on a CUDA device, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _refuse_codes(codes: torch.Tensor, bits: int):
    packing_dims(bits)
    _require_cuda(codes, "codes", torch.int32)


def _refuse_words(words: torch.Tensor, bits: int, count: int):
    G, W = packing_dims(bits)
    _require_cuda(words, "words", torch.int32)
    if words.dim() != 2 or words.shape[1] != W:
        raise ValueError(f"words must be (n, {W}) for {bits} bits, got "
                         f"{tuple(words.shape)}")
    raise ValueError(f"count {count} exceeds the {words.shape[0] * G} codes "
                     f"of the stream")


def pack_codes_cuda(codes: torch.Tensor, *, bits: int) -> torch.Tensor:
    """int32 codes (any shape, on the card) -> (ceil(N/G), W) int32 words."""
    codes = codes.reshape(-1)
    if not (1 <= bits <= 32 and codes.is_cuda
            and codes.dtype == torch.int32 and codes.is_contiguous()):
        _refuse_codes(codes, bits)
    G, W = _DIMS[bits]
    count = codes.numel()
    n = -(-count // G)
    words = codes.new_empty((n, W))
    if n:
        dev = codes.get_device()
        _build.check(_build.library().rt_pack_codes(
            codes.data_ptr(), count, words.data_ptr(), n, bits, dev,
            _build.stream_of(codes)), "pack_codes")
    return words


def unpack_codes_cuda(words: torch.Tensor, *, bits: int,
                      count: int) -> torch.Tensor:
    """(n, W) int32 words on the card -> (count,) int32 codes."""
    dims = _DIMS[bits] if 1 <= bits <= 32 else (0, 0)
    shape = words.shape
    if not (words.is_cuda and words.dtype == torch.int32
            and words.is_contiguous() and len(shape) == 2
            and shape[1] == dims[1] and 0 <= count <= shape[0] * dims[0]):
        _refuse_words(words, bits, count)
    codes = words.new_empty((count,))
    if count:
        dev = words.get_device()
        _build.check(_build.library().rt_unpack_codes(
            words.data_ptr(), shape[0], codes.data_ptr(), count, bits, dev,
            _build.stream_of(words)), "unpack_codes")
    return codes
