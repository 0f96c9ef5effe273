"""Plain PyTorch versions of every CUDA kernel of the port.

Port of ``repro.kernels.ref`` for the kernels of the port. The
wrappers in :mod:`repro_torch.kernels.ops` run these for tensors on the
CPU; ``chip_smoke.py`` holds each CUDA kernel against them on the card.

Words are int32 tensors carrying uint32 bit patterns. ``>>`` on int32 is
arithmetic in PyTorch and the CPU has no uint32 shifts, so every shift
here runs in int64 masked to 32 bits; a straddling code would otherwise
pick up sign bits.
"""
from __future__ import annotations

import math

import torch

from .pack_bits import packing_dims

MASK32 = 0xFFFFFFFF

#: near-tie rule: a code may differ from the reference only where the
#: reference's gap (second-best score - best score) is at most
#: ``NEAR_TIE_RTOL * (1 + |best|)``
NEAR_TIE_RTOL = 1e-3


def as_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same bit pattern."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def as_uint32_values(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 tensor of their unsigned values."""
    return words.to(torch.int64) & MASK32


# ------------------------------------------------------------- pack/unpack

def pack_codes_ref(codes, *, bits: int) -> torch.Tensor:
    """Flat/any-shape int codes -> (ceil(N/G), W) int32 words."""
    G, W = packing_dims(bits)
    flat = torch.as_tensor(codes).reshape(-1).to(torch.int64) \
        & ((1 << bits) - 1)
    pad = (-flat.numel()) % G
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    grp = flat.reshape(-1, G)
    cols = [grp.new_zeros(grp.shape[0]) for _ in range(W)]
    for j in range(G):
        w0, s = divmod(j * bits, 32)
        c = grp[:, j]
        cols[w0] = cols[w0] | ((c << s) & MASK32)
        if s + bits > 32:                                 # straddles a word
            cols[w0 + 1] = cols[w0 + 1] | (c >> (32 - s))
    return as_int32_bits(torch.stack(cols, dim=1))


def unpack_codes_ref(words: torch.Tensor, *, bits: int,
                     count: int) -> torch.Tensor:
    """(n, W) int32 words -> (count,) int32 codes."""
    G, _ = packing_dims(bits)
    w = as_uint32_values(words)
    mask = (1 << bits) - 1
    cols = []
    for j in range(G):
        w0, s = divmod(j * bits, 32)
        v = w[:, w0] >> s
        if s + bits > 32:
            v = v | (w[:, w0 + 1] << (32 - s))
        cols.append(v & mask)
    return as_int32_bits(torch.stack(cols, dim=1).reshape(-1)[:count])


def pad_records(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """(R, n) codes -> (R, ceil(n/G)*G): each record zero-padded to whole
    super-groups, so the row-major flattening packs into the
    concatenation of the per-record streams."""
    G, _ = packing_dims(bits)
    pad = (-codes.shape[1]) % G
    if pad:
        codes = torch.cat([codes, codes.new_zeros(codes.shape[0], pad)], 1)
    return codes


def unpack_records_ref(words: torch.Tensor, *, bits: int, n_records: int,
                       per_record: int) -> torch.Tensor:
    """Per-record streams -> (n_records, per_record) int32 codes."""
    G, _ = packing_dims(bits)
    flat = unpack_codes_ref(words, bits=bits, count=words.shape[0] * G)
    return flat.reshape(n_records, -1)[:, :per_record]


# ------------------------------------------------------------------ decode

def decode_codes_ref(words: torch.Tensor, table: torch.Tensor, *, bits: int,
                     count: int, n_slices: int = 1,
                     phases=None) -> torch.Tensor:
    """(n, W) words + (n_slices*rows, F) table -> (count, F) table rows.

    Code ``j`` of stream group ``g`` belongs to slice
    ``(phases[g] + j) % n_slices`` and gathers row ``slice*rows + code``.
    A row index past the table gathers zeros, as the kernels' gathers do.
    """
    G, _ = packing_dims(bits)
    n = words.shape[0]
    n_tab = table.shape[0]
    codes = unpack_codes_ref(words, bits=bits, count=n * G).to(torch.int64)
    if n_slices > 1:
        pos = torch.arange(n * G, device=words.device)
        if phases is None:
            sl = pos % n_slices
        else:
            ph = torch.as_tensor(phases, device=words.device).reshape(-1)
            sl = (ph.to(torch.int64)[pos // G] + pos % G) % n_slices
        codes = sl * (n_tab // n_slices) + codes
    codes = codes[:count]
    padded = torch.cat([table, table.new_zeros(1, table.shape[1])])
    return padded[torch.where(codes < n_tab, codes, n_tab)]


# --------------------------------------------------------------- vq search

def vq_scores(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """(N, M) latents + (K, M) atoms -> (N, K) scores ``||e||^2 - 2 z.e``
    in float32, whose argmin is the nearest atom."""
    zf, cb = z.float(), codebook.float()
    return (cb * cb).sum(-1)[None, :] - 2.0 * zf @ cb.T


def vq_nearest_ref(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """(N, M), (K, M) -> (N,) int32 nearest atom; ties to the lower index."""
    return vq_scores(z, codebook).argmin(-1).to(torch.int32)


# ------------------------------------------------------------------ encode

def _is_gsvq(n_groups: int, n_slices: int) -> bool:
    return n_groups > 1 or n_slices > 1


def encode_scores(z: torch.Tensor, codebooks: torch.Tensor, *,
                  n_groups: int = 1, n_slices: int = 1) -> torch.Tensor:
    """(R, P, M) latents + (R, K, M) codebooks -> (R, P*S, C) scores whose
    argmin is the transmitted code.

    Plain VQ: ``||e||^2 - 2 z.e`` over the K atoms (no ``||z||^2``).
    GSVQ: per slice, ``sqrt(max(d^2, 0) + 1e-12)`` mean-pooled over each
    group's ``K / n_groups`` atoms, over the slice's ``n_groups`` groups;
    row ``p*S + s`` is slice ``s`` of position ``p``.
    """
    R, P, M = z.shape
    K = codebooks.shape[1]
    zf = z.float()
    cb = codebooks.float()
    if not _is_gsvq(n_groups, n_slices):
        e2 = (cb * cb).sum(-1)                                  # (R, K)
        return e2[:, None, :] - 2.0 * torch.bmm(zf, cb.transpose(1, 2))
    S, m, ng = n_slices, M // n_slices, K // n_groups
    zsl = zf.reshape(R, P, S, m)
    csl = cb.reshape(R, K, S, m).permute(0, 2, 1, 3)            # (R, S, K, m)
    z2 = (zsl * zsl).sum(-1, keepdim=True)                      # (R, P, S, 1)
    e2 = (csl * csl).sum(-1)                                    # (R, S, K)
    cross = torch.einsum("rpsm,rskm->rpsk", zsl, csl)
    d2 = torch.clamp(z2 - 2.0 * cross + e2[:, None], min=0.0)
    d = torch.sqrt(d2 + 1e-12)
    gd = d.reshape(R, P, S, n_groups, ng).mean(-1)              # (R, P, S, G)
    return gd.reshape(R, P * S, n_groups)


def encode_stats(z: torch.Tensor, codes: torch.Tensor, n_atoms: int, *,
                 n_groups: int = 1, n_slices: int = 1):
    """Eq. 7-8 statistics of (R, P*S) codes -> (counts (R, K), sums (R, K, M)).

    GSVQ codes are group indices: each slice's code votes its position's
    FULL latent onto the group's representative atom ``g*ng + ng//2``.
    """
    R, P, M = z.shape
    gsvq = _is_gsvq(n_groups, n_slices)
    S = n_slices if gsvq else 1
    ng = n_atoms // n_groups if gsvq else 1
    rep = codes.to(torch.int64) * ng + ng // 2                  # (R, P*S)
    votes = z.float()
    if S > 1:
        votes = votes.repeat_interleave(S, dim=1)
    counts = torch.zeros((R, n_atoms), dtype=torch.float32, device=z.device)
    counts.scatter_add_(1, rep, torch.ones_like(rep, dtype=torch.float32))
    flat = (rep + torch.arange(R, device=z.device)[:, None] * n_atoms)
    sums = torch.zeros((R * n_atoms, M), dtype=torch.float32, device=z.device)
    sums.index_add_(0, flat.reshape(-1), votes.reshape(-1, M))
    return counts, sums.reshape(R, n_atoms, M)


def encode_codes_ref(z: torch.Tensor, codebooks: torch.Tensor, *, bits: int,
                     n_groups: int = 1, n_slices: int = 1):
    """(R, P, M) latents + (R, K, M) per-record codebooks ->
    (words (R*nW, W) int32, counts (R, K), sums (R, K, M)).

    Per record: quantize against that record's codebook, pack its codes
    into its own zero-padded stream, and sum the EMA statistics.
    """
    scores = encode_scores(z, codebooks, n_groups=n_groups,
                           n_slices=n_slices)
    codes = scores.argmin(-1).to(torch.int32)                  # ties: first
    counts, sums = encode_stats(z, codes, codebooks.shape[1],
                                n_groups=n_groups, n_slices=n_slices)
    words = pack_codes_ref(pad_records(codes, bits), bits=bits)
    return words, counts, sums


def near_ties(scores: torch.Tensor) -> torch.Tensor:
    """Bool mask of codes that the near-tie rule lets differ: the gap
    between the second-best and the best score is at most
    ``NEAR_TIE_RTOL * (1 + |best|)``."""
    if scores.shape[-1] < 2:
        return torch.zeros(scores.shape[:-1], dtype=torch.bool,
                           device=scores.device)
    top2 = scores.topk(2, dim=-1, largest=False).values
    best = top2[..., 0]
    return (top2[..., 1] - best) <= NEAR_TIE_RTOL * (1.0 + best.abs())


def code_mismatches(codes: torch.Tensor, ref_codes: torch.Tensor,
                    ref_scores: torch.Tensor):
    """(codes that differ, of which outside the near-tie rule)."""
    diff = codes.reshape(ref_scores.shape[:-1]).to(torch.int64) \
        != ref_codes.reshape(ref_scores.shape[:-1]).to(torch.int64)
    return int(diff.sum()), int((diff & ~near_ties(ref_scores)).sum())


# ------------------------------------------------------------ LM kernels

def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """(..., d) rows -> ``x * rsqrt(mean(x^2) + eps) * scale`` in float32,
    cast back to x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


#: the masked-score fill of the flash kernels: finite, so a row whose
#: first KV tile is wholly masked gives exp(0) = 1 there, not NaN
NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        scale=None) -> torch.Tensor:
    """(B, Tq, Hq, D) queries, (B, Tk, Hkv, D) keys and values ->
    (B, Tq, Hq, D). Materialised softmax attention; query head ``h`` reads
    KV head ``h // (Hq // Hkv)`` (GQA). Scores are scaled after the dot,
    masked keys (``kpos > qpos`` when causal, ``kpos <= qpos - window``
    when ``window``) score ``-1e30``."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    heads = torch.arange(H, device=q.device) // (H // k.shape[2])
    kf = k.float().index_select(2, heads)
    vf = v.float().index_select(2, heads)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    qpos = torch.arange(Tq, device=q.device)[:, None]
    kpos = torch.arange(Tk, device=q.device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def selective_scan_ref(decay: torch.Tensor, inp: torch.Tensor,
                       c: torch.Tensor, h0: torch.Tensor):
    """The sequential loop: ``h_t = decay_t * h_{t-1} + inp_t``, ``y_t =
    <h_t, c_t>_N``. decay, inp (B, T, di, N); c (B, T, N); h0 (B, di, N)
    -> (y (B, T, di), h_last (B, di, N)), float32."""
    d, i, cf = decay.float(), inp.float(), c.float()
    h = h0.float()
    ys = []
    for t in range(d.shape[1]):
        h = d[:, t] * h + i[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]))
    return torch.stack(ys, 1), h
