"""Fused latent -> packed-code + EMA-stats encode: layout and CUDA wrapper.

Port of ``repro.kernels.encode_codes``. One dispatch quantizes every
latent row of every record against that record's own codebook, packs the
codes into the record's zero-padded word stream, and sums the per-atom
counts and latents of Eq. 7-8, so the Step 5 refresh needs no second
encoder pass. The kernels are ``csrc/encode_codes.cu``; their plain
version is :func:`repro_torch.kernels.ref.encode_codes_ref`.

The wrapper picks one of two kernels from the shapes (:func:`encode_path`):
``"resident"`` for plain VQ whose codebook stays in shared memory (every
DVQ-AE config's uplink), on ``vq_nn.cu``'s search, so its codes equal
:func:`~repro_torch.kernels.vq_nn.vq_nearest_cuda`'s; ``"thread_per_row"``
for GSVQ and codebooks too large to keep.
"""
from __future__ import annotations

import functools
import math

import torch

from . import _build
from .pack_bits import _require_cuda, packing_dims

#: threads (and so rows) per block of the thread-per-row kernel, rounded to
#: whole super-groups and whole positions
BLOCK_ROWS = 256
#: rows of a tile of the resident kernel, and atoms of its sub-tile
TILE_ROWS = TILE_ATOMS = 128
#: shared memory the resident kernel may take: one block an SM, the SM's
#: 228 KB less 3 KB (a block's reserved 1 KB and static arrays)
RESIDENT_BUDGET = (228 - 3) * 1024


def stacked_slice_table(codebooks: torch.Tensor, *,
                        n_slices: int) -> torch.Tensor:
    """(R, K, M) codebooks -> (R, n_slices * K, m) slice-stacked tables.

    Slice ``s`` of record ``r`` owns rows ``[s*K, (s+1)*K)``; group ``g``
    of slice ``s`` is the ``ng`` consecutive rows at ``s*K + g*ng``.
    """
    R, K, M = codebooks.shape
    m = M // n_slices
    return codebooks.reshape(R, K, n_slices, m).permute(0, 2, 1, 3) \
        .reshape(R, n_slices * K, m).contiguous()


def block_rows(n_slices: int) -> int:
    """Rows per CUDA block: a multiple of lcm(32, S) near BLOCK_ROWS —
    whole warps, whole positions, and whole super-groups (G divides 32)."""
    unit = 32 * n_slices // math.gcd(32, n_slices)
    return unit * max(1, BLOCK_ROWS // unit)


def resident_bytes(K: int, M: int) -> int:
    """Shared memory of the resident kernel at K atoms of width M <= 64: the
    codebook in rows of MT + 4 floats (MT the width rounded up to 16, 32 or
    64), padded to whole atom sub-tiles, with its norms; two z tiles; a
    tile's codes; the (K, M) sums; K counts. The same sum as
    ``resident_smem`` in ``csrc/encode_codes.cu``, whose entry refuses a
    launch that does not fit."""
    MT = 16 if M <= 16 else 32 if M <= 32 else 64
    k_pad = -(-K // TILE_ATOMS) * TILE_ATOMS
    return 4 * (k_pad * (MT + 5) + 2 * TILE_ROWS * (MT + 4) + TILE_ROWS
                + K * M + K)


def encode_path(K: int, M: int, *, n_groups: int = 1,
                n_slices: int = 1) -> str:
    """The kernel that encodes K atoms of width M: ``"resident"`` for plain
    VQ whose codebook, two z tiles and (K, M) sums fit one block an SM
    (K <= 256 at M = 64) and whose width is at most 32 or even (a lane adds
    two aligned columns past 32), ``"thread_per_row"`` else."""
    if n_groups > 1 or n_slices > 1 or M > 64 or (M > 32 and M % 2) \
            or resident_bytes(K, M) > RESIDENT_BUDGET:
        return "thread_per_row"
    return "resident"


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def encode_codes_cuda(z: torch.Tensor, codebooks: torch.Tensor, *,
                      bits: int, n_groups: int = 1, n_slices: int = 1):
    """(R, P, M) float32 latents + (R, K, M) codebooks on the card ->
    (words (R*nW, W) int32, counts (R, K), sums (R, K, M))."""
    _require_cuda(z, "z", torch.float32)
    _require_cuda(codebooks, "codebooks", torch.float32)
    if z.dim() != 3 or codebooks.dim() != 3:
        raise ValueError(f"z must be (R, P, M) and codebooks (R, K, M), got "
                         f"{tuple(z.shape)} and {tuple(codebooks.shape)}")
    R, P, M = z.shape
    Rc, K, M2 = codebooks.shape
    if (R, M) != (Rc, M2):
        raise ValueError(f"z {tuple(z.shape)} and codebooks "
                         f"{tuple(codebooks.shape)} disagree")
    gsvq = n_groups > 1 or n_slices > 1
    if gsvq and (M % n_slices or K % n_groups):
        raise ValueError(f"M={M} must divide by n_slices={n_slices} and "
                         f"K={K} by n_groups={n_groups}")
    S = n_slices if gsvq else 1
    m = M // S
    ng = K // n_groups if gsvq else 1
    if m > 128:
        raise ValueError(f"the encode kernel takes slice widths up to 128, "
                         f"got {m}")
    bn = block_rows(S)
    if bn > 1024:
        raise ValueError(f"{S} slices need {bn} rows per block; the kernel "
                         f"takes at most 1024")
    G, W = packing_dims(bits)
    Pn = P * S
    nW = -(-Pn // G)
    dev = z.device
    words = torch.empty((R * nW, W), dtype=torch.int32, device=dev)
    counts = torch.empty((R, K), dtype=torch.float32, device=dev)
    sums = torch.empty((R, K, M), dtype=torch.float32, device=dev)
    if Pn == 0 or R == 0:
        return words, counts.zero_(), sums.zero_()
    if encode_path(K, M, n_groups=n_groups, n_slices=n_slices) == "resident":
        # one block an SM, spread over the records, each walking its
        # record's row tiles; one partial a block
        nb = min(-(-P // TILE_ROWS), max(1, _sm_count(dev.index) // R))
        pcounts = torch.empty((R, nb, K), dtype=torch.int32, device=dev)
        psums = torch.empty((R, nb, K, M), dtype=torch.float32, device=dev)
        _build.check(_build.library().rt_encode_codes_resident(
            z.data_ptr(), codebooks.data_ptr(), words.data_ptr(),
            counts.data_ptr(), sums.data_ptr(), pcounts.data_ptr(),
            psums.data_ptr(), R, P, K, M, bits, nb, dev.index,
            _build.stream_of(z)), "encode_codes")
        return words, counts, sums
    NB = -(-Pn // bn)
    table = stacked_slice_table(codebooks, n_slices=S) if gsvq \
        else codebooks
    pcounts = torch.empty((R, NB, K), dtype=torch.float32, device=dev)
    psums = torch.empty((R, NB, K, M), dtype=torch.float32, device=dev)
    _build.check(_build.library().rt_encode_codes(
        z.data_ptr(), table.data_ptr(), words.data_ptr(),
        counts.data_ptr(), sums.data_ptr(), pcounts.data_ptr(),
        psums.data_ptr(), R, P, Pn, m, M, K, S, ng, int(gsvq), bits, bn, NB,
        dev.index, _build.stream_of(z)), "encode_codes")
    return words, counts, sums
