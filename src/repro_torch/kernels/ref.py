"""Plain PyTorch versions of every CUDA kernel of the port.

Port of ``repro.kernels.ref`` for the kernels of the port. The
wrappers in :mod:`repro_torch.kernels.ops` run these for tensors on the
CPU; ``chip_smoke.py`` holds each CUDA kernel against them on the card.
The LM kernels' plain versions take float32 or bfloat16 as the kernels do:
they compute in float32 and round each output once to its type.

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


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                    eps: float = 1e-6):
    """Gradients of :func:`rmsnorm_ref` for an output gradient ``g``, by
    the backward kernel's formula: with ``r = rsqrt(mean(x^2) + eps)``,
    ``dx = r*(g*scale) - x*r^3*<g*scale, x>/d`` a row and ``dscale`` the
    sum over rows of ``g*(x*r)`` -> (dx (..., d), dscale (d,))."""
    xf, gs = x.float(), g.float() * scale.float()
    d = x.shape[-1]
    r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    dot = (gs * xf).sum(-1, keepdim=True)
    dx = gs * r - xf * (r * r * r * (dot / d))
    dscale = (g.float() * (xf * r)).reshape(-1, d).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


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
    s, vf = _masked_scores(q, k, v, causal, window, scale)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def _mask(Tq: int, Tk: int, causal: bool, window: int, device):
    """(Tq, Tk) True where query position qpos sees key position kpos."""
    qpos = torch.arange(Tq, device=device)[:, None]
    kpos = torch.arange(Tk, device=device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def _kv_heads(t: torch.Tensor, H: int) -> torch.Tensor:
    """(B, T, Hkv, D) keys or values read at each of H query heads."""
    heads = torch.arange(H, device=t.device) // (H // t.shape[2])
    return t.float().index_select(2, heads)


def _masked_scores(q, k, v, causal, window, scale=None):
    """((B, H, Tq, Tk) scaled scores, masked ones at NEG_INF; v read at
    every query head)."""
    B, Tq, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), _kv_heads(k, H)) * scale
    mask = _mask(Tq, k.shape[1], causal, window, q.device)
    return torch.where(mask, s, torch.full_like(s, NEG_INF)), \
        _kv_heads(v, H)


def blind_rows(Tq: int, Tk: int, window: int) -> int:
    """The first query row that sees no key (a window past the last key:
    ``qpos >= Tk - 1 + window``), or Tq when every row sees one. The plain
    function's softmax over such a row's Tk scores of -1e30 is uniform: the
    row is the mean of v."""
    return Tk - 1 + window if window and Tk - 1 + window < Tq else Tq


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int = 0) -> torch.Tensor:
    """The (B, H, Tq) log-sum-exp of each query row's scaled, masked
    scores, which the flash forward writes for its backward; +inf on a row
    that sees no key (:func:`blind_rows`), the mark the backward reads
    (in float32 ``-1e30 + log Tk`` rounds back to -1e30)."""
    lse = torch.logsumexp(_masked_scores(q, k, v, causal, window)[0], -1)
    lse[..., blind_rows(q.shape[1], k.shape[1], window):] = math.inf
    return lse


def flash_attention_with_lse_ref(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, *, causal: bool = True,
                                 window: int = 0):
    """(:func:`flash_attention_ref`, :func:`flash_attention_lse_ref`) of
    one call, the same bits as the two, from one pass over the scores."""
    s, vf = _masked_scores(q, k, v, causal, window)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1),
                       vf).to(q.dtype)
    lse = torch.logsumexp(s, -1)
    lse[..., blind_rows(q.shape[1], k.shape[1], window):] = math.inf
    return out, lse


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True, window: int = 0):
    """Gradients of :func:`flash_attention_ref` by the backward kernel's
    formula, Tq queries (q, o, do (B, Tq, Hq, D), lse (B, Hq, Tq)) over Tk
    keys (k, v (B, Tk, Hkv, D)) under the forward's mask: ``P = exp(S*scale
    - lse)`` on the seen keys (0 elsewhere), ``delta = <do, o>`` a row,
    ``dV = P^T dO``, ``dS = P*(dO V^T - delta)``, ``dQ = dS K*scale``,
    ``dK = dS^T Q*scale``, each KV head's gradient summed over its query
    heads -> (dq, dk, dv). A row that sees no key (:func:`blind_rows`; its
    lse +inf) is the mean of v: as ``jax.grad`` of the plain function
    gives it, its dO / Tk goes to every key's dv, its dq is 0 and it adds
    nothing to dk (the mask cuts the scores' gradient)."""
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf, dof = q.float(), _kv_heads(k, H), _kv_heads(v, H), \
        do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    mask = _mask(Tq, Tk, causal, window, q.device)
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]),
                    torch.zeros_like(s))
    delta = (dof * o.float()).sum(-1).transpose(1, 2)        # (B, H, T)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    blind = blind_rows(Tq, Tk, window)
    if blind < Tq:
        dv = dv + dof[:, blind:].sum(1)[:, None] / Tk
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale

    def per_kv_head(t):
        return t.reshape(B, Tk, Hkv, H // Hkv, D).sum(3)

    return dq.to(q.dtype), per_kv_head(dk).to(k.dtype), \
        per_kv_head(dv).to(v.dtype)


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


def selective_scan_bwd_ref(decay: torch.Tensor, inp: torch.Tensor,
                           c: torch.Tensor, h0: torch.Tensor,
                           gy: torch.Tensor, gh: torch.Tensor):
    """Gradients of :func:`selective_scan_ref` for the output gradients
    ``gy`` (B, T, di) and ``gh`` (B, di, N), by the backward kernel's
    reverse-time recurrence: ``g_t = gy_t * c_t + decay_{t+1} * g_{t+1}``
    (g_{T-1} also takes gh), ``d_inp_t = g_t``, ``d_decay_t = g_t *
    h_{t-1}``, ``dc_t = sum_d gy_t[d] * h_t[d]``, ``dh0 = decay_0 * g_0``
    -> (d_decay, d_inp, dc, dh0), computed in float32 and each rounded
    once to its input's type. Every state of the forward is kept (the
    kernel recomputes them from checkpoints)."""
    d, x, cf, gyf = decay.float(), inp.float(), c.float(), gy.float()
    hs = [h0.float()]
    for t in range(d.shape[1]):
        hs.append(d[:, t] * hs[-1] + x[:, t])
    g_next, dd, dx, dc = gh.float(), [], [], []
    for t in reversed(range(d.shape[1])):
        g = gyf[:, t, :, None] * cf[:, t, None, :] + g_next
        dx.append(g)
        dd.append(g * hs[t])
        dc.append(torch.einsum("bdn,bd->bn", hs[t + 1], gyf[:, t]))
        g_next = d[:, t] * g
    return (torch.stack(dd[::-1], 1).to(decay.dtype),
            torch.stack(dx[::-1], 1).to(inp.dtype),
            torch.stack(dc[::-1], 1).to(c.dtype), g_next.to(h0.dtype))
