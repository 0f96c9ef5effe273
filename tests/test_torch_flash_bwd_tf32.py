"""A CPU model of the flash attention backward kernel's arithmetic.

``csrc/flash_attention_bwd.cu`` takes every product on TF32 tensor cores in
three passes (a*b ~ a_hi*b_hi + a_hi*b_lo + a_lo*b_hi; a_hi is a rounded to
TF32 as ``cvt.rna`` rounds, a_lo the remainder cut to TF32 toward zero).
:func:`tiled_attention_bwd` repeats the kernel's algorithm in plain
PyTorch, on its tiles and in its order of summation, with each product
through ``mm``:

* dK and dV: a 64-key block at a time, two warp groups taking turns over
  the (query head of the KV head's group, 16-row query tile) pairs that see
  the block, head-major; each tile's products summed apart and added to its
  group's running sum in float32, and group 1's sums added to group 0's at
  the end. P = 2^(S scale log2(e) - lse log2(e)) on the seen keys, 0 on the
  rest; dS = P (dP - delta).
* dQ = dS K from the dS the dK/dV pass made, 32-key tiles in order, each
  tile's product added to the running sum in float32.
* Past its scratch budget the kernels run over ranges of query rows in
  turn (``flash_attention.bwd_plan``): a key block's dK and dV are then
  summed as above within each range, and the ranges' sums added in order.
* A query row that sees no key (a window past the last key) is the mean
  of v in the plain function: after the last range its dO / Tk is added to
  every key's dV (the kernel's ``flash_bwd_blind``).
* Queries and keys may differ in length (Tq over Tk, whisper's
  cross-attention): the mask is the forward's at positions counted from 0
  on both sides, and keys no query sees (causal, Tk > Tq) get zeros.

What the model does not follow is the order of additions inside one tile's
product: ``mm`` rounds each product to nearest in float32, where the mma's
accumulator truncates. That truncation is why the kernel sums each tile's
passes in a fresh accumulator; ``chip_smoke.py`` is what holds the kernel
itself to the rule on the card.

With three passes the model lands within the port's backward rule,
``1e-5*(1 + m)`` (m the magnitudes summed into each gradient element, as
``chip_smoke.py::flash_bwd_magnitudes`` forms them), of both the port's
plain backward and ``jax.vjp`` of the JAX package's
``repro.kernels.ref.flash_attention_ref``; with one TF32 pass it misses the
rule in dq, dk and dv, which is why the kernel splits. Inputs are drawn with
numpy from a seed and handed to both packages.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    _ds_blocks, bwd_plan)
# the forward's CPU model of the TF32 split: a @ b in three passes, in one
from test_torch_lm_kernels import mm_tf32x1, mm_tf32x3  # noqa: E402

BWD_RTOL = 1e-5                  # of 1 + the gradient's summed magnitudes
KEY_BLOCK, QUERY_TILE, KEY_TILE = 64, 16, 32   # the kernel's tiles
LOG2E = 1.4426950408889634


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU tensors run far faster on one thread than on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seen(qpos, kpos, Tq, Tk, causal, window):
    """(queries, keys) True where a query sees a key, inside Tq and Tk."""
    ok = (qpos[:, None] < Tq) & (kpos[None, :] < Tk)
    if causal:
        ok &= kpos[None, :] <= qpos[:, None]
    if window:
        ok &= kpos[None, :] > qpos[:, None] - window
    return ok


def tiled_attention_bwd(q, k, v, o, lse, do, mm, *, causal, window,
                        ranges=None):
    """(dq, dk, dv) of flash attention by the backward kernel's algorithm
    (module docstring). q, o, do (B, Tq, Hq, D); k, v (B, Tk, Hkv, D); lse
    (B, Hq, Tq); ``ranges`` the (first, end) query rows of each launch, in
    order (default one launch over all Tq)."""
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    # (B, H, T, D) views, both lengths padded with zero rows to the same
    # whole blocks, as the kernel's zero-filled copies
    Tp = -(-max(Tq, Tk) // KEY_BLOCK) * KEY_BLOCK

    def heads(t):
        t = t.permute(0, 2, 1, 3)
        return torch.nn.functional.pad(t, (0, 0, 0, Tp - t.shape[2]))

    qh, kh, vh, doh = heads(q), heads(k), heads(v), heads(do)
    lse2 = torch.nn.functional.pad(lse * LOG2E, (0, Tp - Tq))
    delta = torch.nn.functional.pad(
        (do * o).sum(-1).permute(0, 2, 1), (0, Tp - Tq))
    pos = torch.arange(Tp)
    dk = torch.zeros((B, Hkv, Tp, D))
    dv = torch.zeros((B, Hkv, Tp, D))
    ds_all = torch.zeros((B, Hq, Tp, Tp))         # the scratch: dS
    for k0, r0, r1 in ((k0, r0, r1) for r0, r1 in ranges or [(0, Tq)]
                       for k0 in range(0, Tk, KEY_BLOCK)):
        keys = slice(k0, k0 + KEY_BLOCK)
        q_begin = k0 if causal else 0
        q_end = Tq if not window else min(Tq, k0 + KEY_BLOCK - 1 + window)
        first = q_begin // QUERY_TILE * QUERY_TILE
        tiles = [(h, t0) for h in range(rep)
                 for t0 in range(max(first, r0), min(q_end, r1),
                                 QUERY_TILE)]
        if not tiles:
            continue                               # another launch's keys
        sums = [[torch.zeros((B, Hkv, KEY_BLOCK, D)) for _ in range(2)]
                for _ in range(2)]                 # group -> (dK, dV)
        for it, (hg, t0) in enumerate(tiles):
            rows = slice(t0, t0 + QUERY_TILE)
            heads_at = torch.arange(Hkv) * rep + hg
            qt, dot = qh[:, heads_at, rows], doh[:, heads_at, rows]
            seen = _seen(pos[rows], pos[keys], Tq, Tk, causal, window).T
            st = mm(kh[:, :, keys], qt.transpose(-1, -2))        # S^T
            p = torch.where(seen, torch.exp2(
                st * (scale * LOG2E) - lse2[:, heads_at, None, rows]), 0.0)
            dpt = mm(vh[:, :, keys], dot.transpose(-1, -2))      # dP^T
            dst = p * (dpt - delta[:, heads_at, None, rows])
            ds_all[:, heads_at, rows, keys] = dst.transpose(-1, -2)
            dk_sum, dv_sum = sums[it % 2]
            dv_sum += mm(p, dot)
            dk_sum += mm(dst, qt)
        # unscaled until the last launch that sees these keys
        dk[:, :, keys] += sums[0][0] + sums[1][0]
        dv[:, :, keys] += sums[0][1] + sums[1][1]
        if r1 >= q_end:
            dk[:, :, keys] *= scale
    blind = ref.blind_rows(Tq, Tk, window)
    if blind < Tq:                     # rows that see no key: dO / Tk
        u = doh[:, :, blind:Tq].sum(2).reshape(B, Hkv, rep, D).sum(2)
        dv[:, :, :Tk] += (u / Tk)[:, :, None]
    dq = torch.zeros((B, Hq, Tp, D))
    kq = kh[:, torch.arange(Hq) // rep]
    for k0 in range(0, Tk, KEY_TILE):
        keys = slice(k0, k0 + KEY_TILE)
        dq += mm(ds_all[:, :, :, keys], kq[:, :, keys])
    dq = dq * scale

    def back(t, n):
        return t[:, :, :n].permute(0, 2, 1, 3)

    return back(dq, Tq), back(dk, Tk), back(dv, Tk)


def magnitudes(q, k, v, o, lse, do, causal, window):
    """The terms summed into each gradient, in magnitude (the formula of
    chip_smoke.py's flash_bwd_magnitudes): ``P^T |dO|`` for dv, and with
    ``M = P * (|dO| |V|^T + sum_d |dO||O|)``, ``M |K| scale`` for dq and
    ``M^T |Q| scale`` for dk, each KV head's summed over its query heads."""
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q, ref._kv_heads(k, H)) * scale
    mask = ref._mask(Tq, Tk, causal, window, q.device)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    ado = do.abs()
    dl = (ado * o.abs()).sum(-1).transpose(1, 2)[..., None]
    m = p * (torch.einsum("bqhd,bkhd->bhqk", ado, ref._kv_heads(v.abs(), H))
             + dl)
    m_dq = torch.einsum("bhqk,bkhd->bqhd", m, ref._kv_heads(k.abs(), H)) \
        * scale
    m_dk = torch.einsum("bhqk,bqhd->bkhd", m, q.abs()) * scale
    m_dv = torch.einsum("bhqk,bqhd->bkhd", p, ado)
    blind = ref.blind_rows(Tq, Tk, window)
    if blind < Tq:                     # a row that sees no key: |dO| / Tk
        m_dv = m_dv + ado[:, blind:].sum(1)[:, None] / Tk
    return (m_dq, m_dk.reshape(B, Tk, Hkv, H // Hkv, D).sum(3),
            m_dv.reshape(B, Tk, Hkv, H // Hkv, D).sum(3))


def over_tolerance(got, want, mag):
    """The largest ``|got - want| / (1e-5 (1 + m))`` of each gradient."""
    return [float(((g - torch.as_tensor(np.array(w))).abs()
                   / (BWD_RTOL * (1 + m))).max())
            for g, w, m in zip(got, want, mag)]


def _case(seed, B, T, Hq, Hkv, D, causal, window, Tk=None):
    """Numpy inputs (T queries over Tk keys, default T), the port's plain
    forward's o and lse, and the model's inputs as tensors."""
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((B, T, Hq, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, T if Tk is None else Tk, Hkv, D))
            .astype(np.float32) for _ in range(2))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    lse = ref.flash_attention_lse_ref(tq, tk, tv, causal=causal,
                                      window=window)
    return (q, k, v, do), (tq, tk, tv, o, lse, tdo)


CASES = [                        # (B, T, Hq, Hkv, D, causal, window)
    (1, 65, 2, 1, 64, True, 0),          # GQA 2:1, one key past a block
    (1, 77, 3, 1, 128, False, 0),        # GQA 3:1, full
    (2, 200, 4, 2, 64, True, 0),         # ragged T over four key blocks
    (1, 200, 2, 2, 128, True, 48),       # a window across tiles
    (1, 130, 6, 2, 64, False, 20),       # GQA 3:1, a window, not causal
    (1, 96, 2, 2, 128, True, 0)]


@pytest.mark.parametrize("B,T,Hq,Hkv,D,causal,window", CASES)
def test_tf32x3_model_matches_plain_backward_and_reference_vjp(
        B, T, Hq, Hkv, D, causal, window):
    (q, k, v, do), args = _case(T * D + Hq + window, B, T, Hq, Hkv, D,
                                causal, window)
    got = tiled_attention_bwd(*args, mm_tf32x3, causal=causal, window=window)
    mag = magnitudes(*args, causal, window)
    plain = ref.flash_attention_bwd_ref(*args, causal=causal, window=window)

    def f(a, b, c):
        return jref.flash_attention_ref(
            a, jnp.repeat(b, Hq // Hkv, axis=2),
            jnp.repeat(c, Hq // Hkv, axis=2), causal=causal, window=window)

    vjp = jax.jit(lambda a, b, c, g: jax.vjp(f, a, b, c)[1](g))
    for name, want in (("plain", plain), ("jax.vjp", vjp(q, k, v, do))):
        worst = over_tolerance(got, want, mag)
        assert max(worst) <= 1, f"{name}: dq, dk, dv {worst}x the tolerance"


@pytest.mark.parametrize("B,T,Hq,Hkv,D,causal,window", CASES[1:4])
def test_one_tf32_pass_misses_the_rule(B, T, Hq, Hkv, D, causal, window):
    """Why the kernel splits: one TF32 pass misses 1e-5*(1 + m) of the
    plain backward in each of dq, dk and dv."""
    _, args = _case(T + D + window, B, T, Hq, Hkv, D, causal, window)
    got = tiled_attention_bwd(*args, mm_tf32x1, causal=causal, window=window)
    plain = ref.flash_attention_bwd_ref(*args, causal=causal, window=window)
    worst = over_tolerance(got, plain, magnitudes(*args, causal, window))
    assert min(worst) > 1, worst


@pytest.mark.parametrize("B,T,Hq,Hkv,D,causal,window", CASES[2:5])
def test_model_by_query_ranges_keeps_dq_and_the_rule(B, T, Hq, Hkv, D,
                                                      causal, window):
    """Launched over two query ranges (rows [0, 128) and [128, T)), dq is
    the same bits as one launch's, and dk and dv stay within the rule of
    the plain backward."""
    _, args = _case(T + 2 * D + window, B, T, Hq, Hkv, D, causal, window)
    one = tiled_attention_bwd(*args, mm_tf32x3, causal=causal, window=window)
    two = tiled_attention_bwd(*args, mm_tf32x3, causal=causal, window=window,
                              ranges=[(0, 128), (128, T)])
    assert torch.equal(one[0], two[0])
    plain = ref.flash_attention_bwd_ref(*args, causal=causal, window=window)
    worst = over_tolerance(two, plain, magnitudes(*args, causal, window))
    assert max(worst) <= 1, worst


@pytest.mark.parametrize("B,T,Hq,causal,slices,ranges,mb", [
    (8, 1024, 16, True, 8, [(0, 1024)], 273.2),   # qwen3's training shape
    (8, 1024, 16, False, 4, [(0, 1024)], 268.7),
    (1, 4096, 16, True, 1, [(0, 2944), (2944, 4096)], 279.1),
    (1, 32768, 16, True, 1, 155, 299.6),
    (1, 131072, 16, True, 1, 925, 1081.7)])       # one 128-row range
def test_scratch_holds_delta_and_the_ds_blocks(B, T, Hq, causal, slices,
                                               ranges, mb):
    """The backward's launches and scratch (delta, then the dS blocks of a
    launch's query rows): the whole batch at once where it fits the 302 MB
    budget, slices of the batch, then ranges of whole 128-row groups; past
    that one group's blocks, Hq * T / 2 KB when causal."""
    bc, bounds, floats = bwd_plan(B, T, T, Hq, causal)
    assert bc == slices
    assert (bounds == ranges if isinstance(ranges, list)
            else len(bounds) == ranges)
    assert bounds[0][0] == 0 and bounds[-1][1] == T
    assert all(a[1] == b[0] and a[1] % 128 == 0
               for a, b in zip(bounds, bounds[1:]))
    assert round(floats * 4 / 1e6, 1) == mb


# (B, Tq, Tk, Hq, Hkv, D, causal, window): queries and keys of two lengths,
# every row seeing a key
UNEQUAL = [
    (1, 40, 130, 2, 1, 64, False, 0),    # cross-attention: Tq < Tk
    (2, 130, 40, 4, 2, 128, False, 0),   # Tq > Tk, GQA 2:1
    (1, 70, 150, 2, 2, 64, True, 0),     # causal, keys 70+ unseen: zeros
    (1, 150, 70, 2, 1, 64, True, 0),     # causal, rows past Tk see all
    (1, 100, 200, 2, 1, 128, True, 48),  # a window across tiles
    (1, 60, 120, 3, 1, 64, False, 30)]   # a window, not causal, GQA 3:1


def _vjp_of_reference(q, k, v, do, causal, window):
    Hq, Hkv = q.shape[2], k.shape[2]

    def f(a, b, c):
        return jref.flash_attention_ref(
            a, jnp.repeat(b, Hq // Hkv, axis=2),
            jnp.repeat(c, Hq // Hkv, axis=2), causal=causal, window=window)

    return jax.jit(lambda a, b, c, g: jax.vjp(f, a, b, c)[1](g))(q, k, v,
                                                                 do)


@pytest.mark.parametrize("B,Tq,Tk,Hq,Hkv,D,causal,window", UNEQUAL)
def test_tf32x3_model_at_unequal_lengths(B, Tq, Tk, Hq, Hkv, D, causal,
                                         window):
    """The model at Tq != Tk within the rule of the plain backward and of
    jax.vjp of the reference's attention; by two query ranges dq keeps
    its bits and dk, dv the rule; one TF32 pass misses it."""
    (q, k, v, do), args = _case(Tq + 3 * Tk + D + window, B, Tq, Hq, Hkv,
                                D, causal, window, Tk=Tk)
    got = tiled_attention_bwd(*args, mm_tf32x3, causal=causal, window=window)
    mag = magnitudes(*args, causal, window)
    plain = ref.flash_attention_bwd_ref(*args, causal=causal, window=window)
    for name, want in (("plain", plain), ("jax.vjp", _vjp_of_reference(
            q, k, v, do, causal, window))):
        worst = over_tolerance(got, want, mag)
        assert max(worst) <= 1, f"{name}: dq, dk, dv {worst}x the tolerance"
    if causal and Tk > Tq:                   # keys no query sees
        assert not got[1][:, Tq:].any() and not got[2][:, Tq:].any()
    if Tq > 16:
        two = tiled_attention_bwd(*args, mm_tf32x3, causal=causal,
                                  window=window, ranges=[(0, 16), (16, Tq)])
        assert torch.equal(got[0], two[0])
        assert max(over_tolerance(two, plain, mag)) <= 1
    one = tiled_attention_bwd(*args, mm_tf32x1, causal=causal, window=window)
    assert max(over_tolerance(one, plain, mag)) > 1


def _blocks_seen(qb0, qb1, Tk, causal):
    """The dS blocks of query blocks [qb0, qb1) a query can see, counted
    one by one (no window: the layout keeps every block a window hides)."""
    nbk = -(-Tk // 16)
    return sum(1 for qb in range(qb0, qb1) for kb in range(nbk)
               if not (causal and kb > qb))


@pytest.mark.parametrize("Tq,Tk", [(384, 1500), (1500, 1500), (333, 100),
                                   (100, 333), (7, 1000), (1, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_ds_blocks_count_the_blocks_a_query_sees(Tq, Tk, causal):
    """_ds_blocks' closed form (the scratch's layout, causal rows past the
    last key block holding every key block) against a count, over every
    query-block range of a 128-row split."""
    nq = -(-Tq // 16)
    for qb0 in range(0, nq, 8):
        for qb1 in (min(nq, qb0 + 8), nq):
            assert _ds_blocks(qb0, qb1, -(-Tk // 16), causal) == \
                _blocks_seen(qb0, qb1, Tk, causal), (qb0, qb1)


@pytest.mark.parametrize("B,Tq,Tk,Hq,causal,slices,ranges,mb", [
    (8, 384, 1500, 8, False, 8, [(0, 384)], 147.9),    # whisper's cross
    (8, 1500, 1500, 8, False, 4, [(0, 1500)], 289.7),  # its encoder
    (8, 384, 384, 8, True, 8, [(0, 384)], 19.8),       # its decoder
    (1, 32768, 1024, 16, True, 1, 8, 296.2),           # causal, Tq >> Tk
    (1, 1024, 32768, 16, False, 1, 8, 268.5)])         # one group a range
def test_scratch_at_unequal_lengths(B, Tq, Tk, Hq, causal, slices, ranges,
                                    mb):
    """bwd_plan at Tq queries over Tk keys: the whole batch where it fits
    the budget (whisper's cross-attention, 148 MB), slices of the batch
    (its encoder: 4 of 8), then ranges of whole 128-row groups."""
    bc, bounds, floats = bwd_plan(B, Tq, Tk, Hq, causal)
    assert bc == slices
    assert (bounds == ranges if isinstance(ranges, list)
            else len(bounds) == ranges)
    assert bounds[0][0] == 0 and bounds[-1][1] == Tq
    assert all(a[1] == b[0] and a[1] % 128 == 0
               for a, b in zip(bounds, bounds[1:]))
    assert round(floats * 4 / 1e6, 1) == mb


def test_a_row_that_sees_no_key_takes_the_reference_gradient():
    """A window past the last key (Tq > Tk - 1 + window) leaves query rows
    that see no key. The reference's plain attention masks with a finite
    -1e30, so such a row is the mean of v over the Tk keys, and under
    ``jax.vjp`` its dO / Tk goes to every key's dv, its dq is 0 and it adds
    nothing to dk. The port's plain forward equals the reference's within
    2e-5, its lse marks those rows +inf, and its plain backward and the
    model of the kernel (which adds the rows' dv term after the last range)
    hold the rule against ``jax.vjp`` of the reference, dq exactly 0 on
    those rows."""
    B, Tq, Tk, Hq, Hkv, D, w = 1, 40, 10, 2, 1, 64, 5
    seen = Tk - 1 + w                     # rows [0, seen) see a key
    assert ref.blind_rows(Tq, Tk, w) == seen
    (q, k, v, do), args = _case(99, B, Tq, Hq, Hkv, D, False, w, Tk=Tk)
    tq, tk, tv, o, lse, tdo = args
    want_o = jref.flash_attention_ref(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), Hq // Hkv, axis=2),
        jnp.repeat(jnp.asarray(v), Hq // Hkv, axis=2), causal=False,
        window=w)
    assert float((o - torch.from_numpy(np.array(want_o))).abs().max()) \
        <= 2e-5
    mean_v = tv.mean(1)[:, None].repeat_interleave(Hq // Hkv, dim=2)
    assert float((o[:, seen:] - mean_v).abs().max()) <= 2e-6
    assert bool(torch.isinf(lse[..., seen:]).all()) \
        and bool(torch.isfinite(lse[..., :seen]).all())
    want = _vjp_of_reference(q, k, v, do, False, w)
    assert not np.asarray(want[0])[:, seen:].any()
    mag = magnitudes(*args, False, w)
    for label, fn in (
            ("plain", lambda *a: ref.flash_attention_bwd_ref(
                *a, causal=False, window=w)),
            ("model", lambda *a: tiled_attention_bwd(
                *a, mm_tf32x3, causal=False, window=w))):
        dq, dk, dv = fn(*args)
        assert not dq[:, seen:].any(), label
        worst = over_tolerance((dq, dk, dv), want, mag)
        assert max(worst) <= 1, (label, worst)
