"""Fused latent -> packed-code + EMA-stats encode: layout and CUDA wrapper.

Port of ``repro.kernels.encode_codes``. One dispatch quantizes every
latent row of every record against that record's own codebook, packs the
codes into the record's zero-padded word stream, and sums the per-atom
counts and latents of Eq. 7-8, so the Step 5 refresh needs no second
encoder pass. The kernels are ``csrc/encode_codes.cu``; their plain
version is :func:`repro_torch.kernels.ref.encode_codes_ref`.

The wrapper picks one of three kernels from the shapes
(:func:`encode_path`): ``"resident"`` for plain VQ whose codebook stays in
shared memory (every DVQ-AE config's uplink), on ``vq_nn.cu``'s search, so
its codes equal :func:`~repro_torch.kernels.vq_nn.vq_nearest_cuda`'s;
``"gsvq_tiled"`` for GSVQ whose slice tables stay in shared memory (the
speech config's 3-bit uplink), a register-tiled FP32 group search;
``"thread_per_row"`` for the rest (larger tables, slice widths past 64 or
not a multiple of 4).

A record's words, counts and sums are the same bits whatever other records
share its launch: every path splits a record's rows into statistics
partials by the record's own shape (:func:`resident_partials`,
:func:`gsvq_partials`, :func:`block_rows`), never by R or the card's SM
count, and adds the partials in a fixed order.
"""
from __future__ import annotations

import math

import torch

from . import _build
from .pack_bits import _require_cuda, packing_dims

#: threads (and so rows) per block of the thread-per-row kernel, rounded to
#: whole super-groups and whole positions
BLOCK_ROWS = 256
#: rows of a tile of the resident kernel, and atoms of its sub-tile
TILE_ROWS = TILE_ATOMS = 128
#: shared memory the resident and tiled GSVQ kernels may take: one block an
#: SM, the SM's 228 KB less 3 KB (a block's reserved 1 KB and static arrays)
RESIDENT_BUDGET = (228 - 3) * 1024
#: slice rows of a pass of the tiled GSVQ kernel: two units of 32
GSVQ_PASS_ROWS = 64
#: warps of the tiled GSVQ kernel that add votes, each into its own sums
GSVQ_VOTE_WARPS = 8
#: statistics partials a record gets on the resident path: one per
#: PARTIAL_ROWS rows, at least MIN_PARTIALS and at most MAX_PARTIALS (and
#: never more than its row tiles). Each is a (K, M) float block written and
#: read once, so their number grows with the record's rows, not with the card
PARTIAL_ROWS = 512
MIN_PARTIALS = 32
MAX_PARTIALS = 128


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


def gsvq_tile_positions(n_slices: int) -> int:
    """Positions of a tile of the tiled GSVQ kernel: 32, so a slice's rows
    of the tile are one unit of 32 (64 at one slice: two units a tile)."""
    return 64 if n_slices == 1 else 32


def gsvq_bytes(K: int, M: int, *, n_groups: int, n_slices: int) -> int:
    """Shared memory of the tiled GSVQ kernel: the S slice tables in rows of
    RS floats (RS / 4 odd) with their norms, two (BP, M) latent tiles in
    rows of RSZ floats (RSZ / 4 odd), a pass's distances (64 rows of
    n_groups groups of ng floats rounded up to odd), the tile's codes, the
    vote warps' copies of the (n_groups, M) sums, n_groups counts and each
    atom's score column, each region a multiple of 4 floats. The same sum as
    ``gs::layout`` in ``csrc/encode_codes.cu``, whose entry refuses a launch
    that does not fit."""
    S, m, ng = n_slices, M // n_slices, K // n_groups
    BP = gsvq_tile_positions(S)
    RS, RSZ = 4 * ((m // 4) | 1), 4 * ((M // 4) | 1)
    KS = n_groups * (ng | 1)
    regions = (S * K * RS, S * K, 2 * BP * RSZ, GSVQ_PASS_ROWS * KS, BP * S,
               GSVQ_VOTE_WARPS * n_groups * M, n_groups, K)
    return 4 * sum(-(-n // 4) * 4 for n in regions)


def encode_path(K: int, M: int, *, n_groups: int = 1,
                n_slices: int = 1) -> str:
    """The kernel that encodes K atoms of width M: ``"resident"`` for plain
    VQ whose codebook, two z tiles and (K, M) sums fit one block an SM
    (K <= 256 at M = 64) and whose width is at most 32 or even (a lane adds
    two aligned columns past 32); ``"gsvq_tiled"`` for GSVQ with slice
    widths m <= 64, m % 4 == 0, whose tables and tiles fit one block an SM
    (:func:`gsvq_bytes`); ``"thread_per_row"`` else."""
    if n_groups > 1 or n_slices > 1:
        m = M // n_slices
        if M % n_slices or K % n_groups or m % 4 or m > 64 \
                or gsvq_bytes(K, M, n_groups=n_groups, n_slices=n_slices) \
                > RESIDENT_BUDGET:
            return "thread_per_row"
        return "gsvq_tiled"
    if M > 64 or (M > 32 and M % 2) or resident_bytes(K, M) > RESIDENT_BUDGET:
        return "thread_per_row"
    return "resident"


def resident_partials(P: int) -> int:
    """Blocks a record of the resident kernel, each walking every nb-th row
    tile of it into one statistics partial. A function of the record's rows
    alone: a record's sums, reduced over its partials in a fixed order, are
    then the same bits whatever stack of records it rides in."""
    tiles = -(-P // TILE_ROWS)
    return min(tiles, MAX_PARTIALS, max(MIN_PARTIALS, P // PARTIAL_ROWS))


def gsvq_partials(P: int, n_slices: int) -> int:
    """Blocks a record of the tiled GSVQ kernel, each walking every nb-th
    tile: one a tile up to MAX_PARTIALS, a function of the record's shape
    alone (a partial is only (n_groups, M) floats)."""
    return min(-(-P // gsvq_tile_positions(n_slices)), MAX_PARTIALS)


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
    path = encode_path(K, M, n_groups=n_groups, n_slices=n_slices)
    if path == "gsvq_tiled":
        # the slice tables resident; grid (nb, R): each block walks its
        # record's tiles into one (n_groups, M) partial, nb from the
        # record's shape alone
        nb = gsvq_partials(P, S)
        pcounts = torch.empty((R, nb, n_groups), dtype=torch.int32,
                              device=dev)
        psums = torch.empty((R, nb, n_groups, M), dtype=torch.float32,
                            device=dev)
        _build.check(_build.library().rt_encode_codes_gsvq(
            z.data_ptr(), codebooks.data_ptr(), words.data_ptr(),
            counts.data_ptr(), sums.data_ptr(), pcounts.data_ptr(),
            psums.data_ptr(), R, P, K, M, S, n_groups, bits, nb, dev.index,
            _build.stream_of(z)), "encode_codes")
        return words, counts, sums
    if path == "resident":
        # grid (nb, R): each block walks its record's row tiles into one
        # partial, nb from the record's rows alone
        nb = resident_partials(P)
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
