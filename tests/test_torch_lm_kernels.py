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
"""
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
