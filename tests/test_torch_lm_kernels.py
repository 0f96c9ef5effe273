"""Port parity: the LM kernels' plain versions (rmsnorm, flash attention)
against the JAX package on shared numpy inputs.

The JAX side runs as its own tests run it off-TPU: the Pallas kernels in
interpret mode, beside ``repro.kernels.ref`` and the plain ``repro.nn``
functions. On the CPU the port's ``ops`` runs the plain versions in
``repro_torch.kernels.ref``; the CUDA kernels themselves are held against
those on the card by ``chip_smoke.py``.

Tolerances: rmsnorm 2e-6 absolute and relative (float32 rsqrt and a mean
taken in another order); attention 2e-5 absolute and relative, as the
reference holds its Pallas kernel to its oracle (the Pallas kernel scales
q before the dot, the plain versions scale the scores after it, and the
online softmax sums in another order).

The CUDA flash kernel takes its two products on TF32 tensor cores in three
passes (a*b ~ a_hi*b_hi + a_hi*b_lo + a_lo*b_hi; a_hi is a rounded to TF32
as ``cvt.rna`` rounds, a_lo the remainder cut to TF32 toward zero). The
last section models that arithmetic in plain PyTorch, on the kernel's own
tiling, and holds it to the attention tolerance; one TF32 pass misses it,
which is why the kernel splits.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm_pallas  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro.nn.layers import rmsnorm as jlayer_rmsnorm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm_cuda  # noqa: E402
from repro_torch.nn import attention as attn  # noqa: E402
from repro_torch.nn.layers import rmsnorm as layer_rmsnorm  # noqa: E402

RMS_TOL = 2e-6
ATTN_TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU tensors run far faster on one thread than on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed, B, T, Hq, Hkv, D, Tk=None):
    rng = np.random.default_rng(seed)
    Tk = T if Tk is None else Tk
    return (rng.standard_normal((B, T, Hq, D)).astype(np.float32),
            rng.standard_normal((B, Tk, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, Tk, Hkv, D)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ---------------------------------------------------------------- rmsnorm

@pytest.mark.parametrize("shape", [(8, 64), (3, 7, 128), (2, 5, 11, 256),
                                   (1, 1024), (13, 130)])
def test_rmsnorm_matches_reference(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    s = rng.standard_normal(shape[-1]).astype(np.float32)
    got = ops.rmsnorm(*_t(x, s)).numpy()
    for want in (rmsnorm_pallas(jnp.asarray(x), jnp.asarray(s),
                                interpret=True),
                 jref.rmsnorm_ref(jnp.asarray(x), jnp.asarray(s)),
                 jlayer_rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x))):
        np.testing.assert_allclose(got, np.asarray(want), atol=RMS_TOL,
                                   rtol=RMS_TOL)
    np.testing.assert_array_equal(got, ref.rmsnorm_ref(*_t(x, s)).numpy())


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_rmsnorm_layer_and_eps(eps):
    """The port's layer (the kernel's door) against the reference layer,
    on rows with a tiny mean square where eps matters."""
    rng = np.random.default_rng(7)
    x = (1e-3 * rng.standard_normal((4, 32, 64))).astype(np.float32)
    s = np.abs(rng.standard_normal(64)).astype(np.float32)
    got = layer_rmsnorm({"scale": torch.from_numpy(s)}, torch.from_numpy(x),
                        eps)
    want = jlayer_rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x), eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=RMS_TOL,
                               rtol=RMS_TOL)


# -------------------------------------------------------------- attention

@pytest.mark.parametrize("t,causal,window", [
    (64, True, 0), (200, True, 0), (128, False, 0), (256, True, 64),
    (300, True, 128), (77, False, 0)])
def test_flash_matches_pallas_and_ref(t, causal, window):
    q, k, v = _qkv(t + window, 2, t, 2, 2, 64)
    got = ops.flash_attention(*_t(q, k, v), causal=causal,
                              window=window).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    for want in (flash_attention_pallas(jq, jk, jv, causal=causal,
                                        window=window, interpret=True),
                 jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                          window=window)):
        np.testing.assert_allclose(got, np.asarray(want), atol=ATTN_TOL,
                                   rtol=ATTN_TOL)


@pytest.mark.parametrize("d,t,tk,hq,hkv,causal", [
    (96, 70, None, 2, 2, True),              # MLA's q/k width (minicpm3-4b)
    (96, 40, 90, 2, 1, False),               # Tq < Tk, GQA 2:1
    (256, 50, None, 2, 2, True),             # gemma-7b's heads
    (256, 33, 20, 4, 2, False),              # Tq > Tk, GQA 2:1
    (192, 60, None, 2, 2, True),             # MLA's q/k width (deepseek-v3)
    (192, 35, 70, 4, 2, False)])             # Tq < Tk, GQA 2:1
def test_flash_new_head_dims_match_pallas(d, t, tk, hq, hkv, causal):
    """The head dims the kernel takes beyond 64 and 128: the plain version
    through ``ops`` against the Pallas kernel in interpret mode (k and v
    repeated to Hq heads, as the reference's ops does) and its oracle."""
    q, k, v = _qkv(d + t, 1, t, hq, hkv, d, Tk=tk)
    got = ops.flash_attention(*_t(q, k, v), causal=causal).numpy()
    rep = hq // hkv
    jq, jk, jv = (jnp.asarray(q), jnp.repeat(jnp.asarray(k), rep, axis=2),
                  jnp.repeat(jnp.asarray(v), rep, axis=2))
    for want in (flash_attention_pallas(jq, jk, jv, causal=causal,
                                        interpret=True),
                 jref.flash_attention_ref(jq, jk, jv, causal=causal)):
        np.testing.assert_allclose(got, np.asarray(want), atol=ATTN_TOL,
                                   rtol=ATTN_TOL)


@pytest.mark.parametrize("hq,hkv,d", [(8, 2, 16), (4, 2, 64), (4, 4, 128),
                                      (16, 8, 128)])
def test_flash_gqa_through_ops(hq, hkv, d):
    """GQA without a repeat (head h reads KV head h // (Hq/Hkv)) against
    the reference's ops, which repeats k and v before the kernel."""
    q, k, v = _qkv(hq * d, 2, 96, hq, hkv, d)
    got = ops.flash_attention(*_t(q, k, v), causal=True).numpy()
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATTN_TOL,
                               rtol=ATTN_TOL)


@pytest.mark.parametrize("hq,hkv,window", [(4, 2, 0), (4, 1, 5), (2, 2, 0)])
def test_attend_full_with_cache_mask(hq, hkv, window):
    """The decode path: one query against a cache under its valid-length
    mask, GQA by grouping, against the reference's repeat-then-attend."""
    q, k, v = _qkv(hq + window, 3, 1, hq, hkv, 64, Tk=20)
    idx = 11
    kpos = np.arange(20)[None, :]
    valid = kpos <= idx
    if window:
        valid &= kpos > idx - window
    valid = np.broadcast_to(valid, (3, 20))
    got = attn.attend(*_t(q, k, v), causal=False,
                      kv_len_mask=torch.from_numpy(valid.copy()))
    want = jattn.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=False, kv_len_mask=jnp.asarray(valid),
                        force_chunked=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL,
                               rtol=ATTN_TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48), (False, 0)])
def test_attend_matches_chunked_twin(causal, window):
    """The port's prefill attention (the flash kernel's door) against the
    reference's chunked online softmax and its plain ``_attend_full``."""
    q, k, v = _qkv(11, 1, 160, 4, 2, 64)
    got = attn.attend(*_t(q, k, v), causal=causal, window=window).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    jk4, jv4 = jnp.repeat(jk, 2, axis=2), jnp.repeat(jv, 2, axis=2)
    for want in (jattn._attend_chunked(jq, jk4, jv4, causal=causal,
                                       q_offset=0, window=window,
                                       kv_chunk=32),
                 jattn._attend_full(jq, jk4, jv4, causal=causal, q_offset=0,
                                    window=window)):
        np.testing.assert_allclose(got, np.asarray(want), atol=ATTN_TOL,
                                   rtol=ATTN_TOL)


def test_plain_full_equals_flash_ref():
    """The two plain paths of the port compute one function."""
    q, k, v = _qkv(5, 2, 70, 4, 2, 64)
    a = attn._attend_full(*_t(q, k, v), causal=True, window=30)
    b = ref.flash_attention_ref(*_t(q, k, v), causal=True, window=30)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-6)


# --------------------------------------------------------------- dispatch

def test_cuda_wrappers_refuse_cpu_tensors():
    x, s = torch.ones(4, 128), torch.ones(128)
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_cuda(x, s)
    q = torch.ones(1, 8, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q)


def test_plain_versions_do_not_count_launches():
    ops.reset_launches()
    q, k, v = _t(*_qkv(1, 1, 16, 2, 1, 64))
    ops.flash_attention(q, k, v)
    ops.rmsnorm(q, torch.ones(64))
    assert ops.LAUNCHES["flash_attention"] == 0
    assert ops.LAUNCHES["rmsnorm"] == 0


# ------------------------------------------- the flash kernel's TF32 split

TF32_TILE = 32                   # keys a KV tile of csrc/flash_attention.cu


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the TF32 value ``cvt.rna.tf32.f32`` gives, by integer bit
    operations: the 23-bit mantissa rounded to 10 bits, to nearest with
    ties away from zero (add half of the dropped field to the magnitude's
    bit pattern, then clear the 13 low bits)."""
    u = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0x1000) & 0xFFFFE000
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u)
    return u.to(torch.int32).view(torch.float32)


def tf32_rz(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 toward zero: the 13 low bits cleared, as the tensor
    core reads an FP32 register."""
    u = x.float().contiguous().view(torch.int32) & -0x2000
    return u.view(torch.float32)


def split_tf32(x: torch.Tensor):
    """x ~ hi + lo with both parts TF32, as the kernel splits an operand:
    hi rounded to nearest, the exact remainder x - hi cut toward zero."""
    hi = tf32_rna(x)
    return hi, tf32_rz(x - hi)


def mm_tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in three TF32 passes with FP32 sums: the two small passes
    first, then the large one (each product of two TF32 values is exact in
    float32)."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm_tf32x1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in one TF32 pass."""
    return tf32_rna(a) @ tf32_rna(b)


def tiled_attention(q, k, v, mm, *, causal, window):
    """The flash kernel's algorithm on the CPU: q scaled before the dot, an
    online softmax over TF32_TILE-key tiles with the finite -1e30 mask, both
    products through ``mm``, the output acc / max(l, 1e-30). GQA by head
    index. (B, Tq, Hq, D), (B, Tk, Hkv, D) -> (B, Tq, Hq, D)."""
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    heads = torch.arange(Hq) // (Hq // Hkv)
    qs = (q * (1.0 / math.sqrt(D))).permute(0, 2, 1, 3)
    kh = k.index_select(2, heads).permute(0, 2, 1, 3)
    vh = v.index_select(2, heads).permute(0, 2, 1, 3)
    m = torch.full((B, Hq, Tq, 1), -1e30)
    l = torch.zeros((B, Hq, Tq, 1))
    acc = torch.zeros((B, Hq, Tq, D))
    qpos = torch.arange(Tq)[:, None]
    for k0 in range(0, Tk, TF32_TILE):
        k1 = min(k0 + TF32_TILE, Tk)
        kpos = torch.arange(k0, k1)[None, :]
        s = mm(qs, kh[:, :, k0:k1].transpose(-1, -2))
        ok = torch.ones((Tq, k1 - k0), dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window:
            ok &= kpos > qpos - window
        s = torch.where(ok, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + mm(p, vh[:, :, k0:k1])
        m = m_new
    return (acc / l.clamp_min(1e-30)).permute(0, 2, 1, 3)


def _rna_numpy(x: np.ndarray) -> np.ndarray:
    """TF32 rounding by another route: 11 significant bits, ties away."""
    mant, exp = np.frexp(x.astype(np.float64))
    r = np.sign(mant) * np.floor(np.abs(mant) * 2.0 ** 11 + 0.5)
    return np.ldexp(r, exp - 11).astype(np.float32)


def test_tf32_rna_bits():
    """Ties go away from zero, a carry moves into the exponent, the low 13
    bits are cleared, and random values round as an independent float64
    rounding to 11 significant bits does."""
    bits = np.array([0x3F800000, 0x3F801000, 0x3F800FFF, 0x3F801001,
                     0xBF801000, 0x3FFFF000, 0x3F803000, 0x00000000,
                     0x80000000], dtype=np.uint32)
    want = np.array([0x3F800000, 0x3F802000, 0x3F800000, 0x3F802000,
                     0xBF802000, 0x40000000, 0x3F804000, 0x00000000,
                     0x80000000], dtype=np.uint32)
    got = tf32_rna(torch.from_numpy(bits.view(np.float32).copy()))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(100_000)
         * 10.0 ** rng.uniform(-6, 6, 100_000)).astype(np.float32)
    got = tf32_rna(torch.from_numpy(x)).numpy()
    assert not (got.view(np.uint32) & 0x1FFF).any()
    np.testing.assert_array_equal(got, _rna_numpy(x))
    hi, lo = split_tf32(torch.from_numpy(x))
    assert not (lo.numpy().view(np.uint32) & 0x1FFF).any()
    err = np.abs((hi.double() + lo.double()).numpy() - x)
    assert (err <= 2.0 ** -21 * np.abs(x)).all()
    # the GPU's canonical NaN rounds up into the sign bit (hi is -0), and
    # the remainder, cut toward zero, carries the NaN on
    nan = torch.from_numpy(np.array([0x7FFFFFFF], np.uint32).view(np.float32))
    hi, lo = split_tf32(nan)
    assert hi.item() == 0.0 and math.isnan(lo.item())


@pytest.mark.parametrize("b,t,hq,hkv,d,causal,window", [
    (1, 200, 2, 2, 64, True, 0),             # ragged T, causal
    (1, 256, 2, 2, 128, True, 0),
    (1, 160, 2, 2, 128, True, 48),           # window across tiles
    (2, 96, 4, 2, 64, True, 0),              # GQA 2:1
    (1, 130, 4, 1, 128, False, 0),           # GQA 4:1, not causal
    (1, 77, 2, 2, 64, False, 20),            # window, not causal
    (1, 100, 2, 2, 96, True, 0),             # D 96: MLA's q/k width
    (1, 70, 2, 1, 256, True, 0),             # D 256: gemma-7b, GQA 2:1
    (1, 90, 2, 2, 192, True, 0)])            # D 192: deepseek-v3's q/k
def test_tf32x3_attention_matches_pallas_and_ref(b, t, hq, hkv, d, causal,
                                                 window):
    q, k, v = _qkv(t * d + hq + window, b, t, hq, hkv, d)
    got = tiled_attention(*_t(q, k, v), mm_tf32x3, causal=causal,
                          window=window).numpy()
    rep = hq // hkv
    jq, jk, jv = (jnp.asarray(q), jnp.repeat(jnp.asarray(k), rep, axis=2),
                  jnp.repeat(jnp.asarray(v), rep, axis=2))
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                    interpret=True)
    plain = ref.flash_attention_ref(*_t(q, k, v), causal=causal,
                                    window=window)
    for want in (np.asarray(pallas), plain.numpy()):
        np.testing.assert_allclose(got, want, atol=ATTN_TOL, rtol=0)


@pytest.mark.parametrize("t,d", [(256, 128), (512, 64)])
def test_one_tf32_pass_misses_the_tolerance(t, d):
    """Why the kernel splits: one TF32 pass lands well outside 2e-5 of the
    plain version on N(0, 1) inputs, three passes well inside it."""
    q, k, v = _t(*_qkv(t + d, 1, t, 2, 2, d))
    plain = ref.flash_attention_ref(q, k, v, causal=True)
    one = (tiled_attention(q, k, v, mm_tf32x1, causal=True, window=0)
           - plain).abs().max().item()
    three = (tiled_attention(q, k, v, mm_tf32x3, causal=True, window=0)
             - plain).abs().max().item()
    assert one > 10 * ATTN_TOL, one
    assert three < ATTN_TOL / 4, three
