"""Port parity: the VQ nearest-atom search, the quantizers and the
public/private split against the JAX package on shared numpy inputs.

The JAX side runs as its own tests run it: ``repro.kernels.ops``
dispatches the Pallas kernel in interpret mode off-TPU.

Tolerances: indices are identical except at near ties (a code may differ
only where the reference's second-best score is within 1e-3*(1+|best|)
of its best); float outputs atol 1e-5 (float32 sums in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import disentangle as jdis  # noqa: E402
from repro.core import gsvq as jgsvq  # noqa: E402
from repro.core import vq as jvq  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import disentangle, gsvq, vq  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU tensors run far faster on one thread than on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _assert_codes(got, want, z, cb):
    """Identical codes, except at near ties of the reference's scores
    (float64)."""
    z64 = np.asarray(z, np.float64).reshape(-1, np.shape(cb)[-1])
    cb64 = np.asarray(cb, np.float64)
    scores = torch.from_numpy((cb64 * cb64).sum(-1)[None] - 2 * z64 @ cb64.T)
    n_diff, n_out = ref.code_mismatches(torch.as_tensor(np.array(got)),
                                        torch.as_tensor(np.array(want)),
                                        scores)
    assert n_out == 0, f"{n_out} codes differ outside the near-tie rule"
    return n_diff


@pytest.mark.parametrize("n,k,m", [(37, 100, 16), (203, 600, 64),
                                   (5, 1, 16), (64, 256, 64)])
def test_vq_nearest_ref_matches_reference(n, k, m):
    rng = np.random.default_rng(n + k + m)
    z = rng.standard_normal((n, m)).astype(np.float32)
    cb = rng.standard_normal((k, m)).astype(np.float32)
    want = np.asarray(jops.vq_nearest(jnp.asarray(z), jnp.asarray(cb)))
    got = ops.vq_nearest(_t(z), _t(cb))
    assert got.dtype == torch.int32 and tuple(got.shape) == (n,)
    _assert_codes(got.numpy(), want, z, cb)
    np.testing.assert_array_equal(ref.vq_nearest_ref(_t(z), _t(cb)).numpy(),
                                  got.numpy())


def test_vq_nearest_ties_keep_the_lower_index():
    """Duplicated atoms score exactly alike: both packages pick the first."""
    rng = np.random.default_rng(3)
    base = rng.standard_normal((40, 16)).astype(np.float32)
    cb = np.concatenate([base, base[::-1], base])          # K = 120
    z = np.concatenate([base + 0.01 * rng.standard_normal((40, 16)),
                        rng.standard_normal((13, 16))]).astype(np.float32)
    want = np.asarray(jops.vq_nearest(jnp.asarray(z), jnp.asarray(cb)))
    got = ops.vq_nearest(_t(z), _t(cb)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:40] < 40).all()
    np.testing.assert_array_equal(got[:40], np.arange(40))


def test_quantize_matches_reference():
    rng = np.random.default_rng(1)
    z = rng.standard_normal((3, 21, 16)).astype(np.float32)
    cb = rng.standard_normal((32, 16)).astype(np.float32)
    j = jvq.quantize(jnp.asarray(z), jnp.asarray(cb))
    zt = _t(z).requires_grad_(True)
    cbt = _t(cb).requires_grad_(True)
    t = vq.quantize(zt, cbt)
    assert _assert_codes(t.indices.numpy(), j.indices, z, cb) == 0
    np.testing.assert_allclose(t.quantized.detach().numpy(),
                               np.asarray(j.quantized), atol=ATOL)
    for name in ("codebook_loss", "commit_loss"):
        np.testing.assert_allclose(float(getattr(t, name).detach()),
                                   float(getattr(j, name)), atol=ATOL)
    np.testing.assert_allclose(float(vq.vq_loss_terms(t, 2.0, 0.5).detach()),
                               float(jvq.vq_loss_terms(j, 2.0, 0.5)),
                               atol=ATOL)
    # straight-through: d sum(z_q) / dz = 1; the losses reach the codebook
    # only through codebook_loss and z only through commit_loss
    (gz,) = torch.autograd.grad(t.quantized.sum(), zt)
    assert torch.equal(gz, torch.ones_like(gz))
    gcb = torch.autograd.grad(t.commit_loss, cbt, allow_unused=True)[0]
    assert gcb is None or float(gcb.abs().max()) == 0.0
    assert vq.codes_nbits(t.indices, 32) == jvq.codes_nbits(j.indices, 32)
    np.testing.assert_allclose(float(vq.perplexity(t.indices, 32)),
                               float(jvq.perplexity(j.indices, 32)),
                               rtol=1e-5)
    np.testing.assert_array_equal(
        vq.nearest_atom(_t(z), _t(cb)).numpy(),
        np.asarray(jvq.nearest_atom(jnp.asarray(z), jnp.asarray(cb))))
    np.testing.assert_array_equal(
        vq.dequantize(t.indices, _t(cb)).numpy(),
        np.asarray(jvq.dequantize(j.indices, jnp.asarray(cb))))


@pytest.mark.parametrize("n_groups,n_slices", [(16, 4), (8, 1), (1, 4)])
def test_gsvq_quantize_matches_reference(n_groups, n_slices):
    rng = np.random.default_rng(n_groups * 10 + n_slices)
    z = rng.standard_normal((2, 19, 16)).astype(np.float32)
    cb = rng.standard_normal((64, 16)).astype(np.float32)
    j = jgsvq.gsvq_quantize(jnp.asarray(z), jnp.asarray(cb),
                            n_groups=n_groups, n_slices=n_slices)
    t = gsvq.gsvq_quantize(_t(z), _t(cb), n_groups=n_groups,
                           n_slices=n_slices)
    np.testing.assert_array_equal(t.indices.numpy(), np.asarray(j.indices))
    np.testing.assert_array_equal(
        gsvq.gsvq_indices(_t(z), _t(cb), n_groups=n_groups,
                          n_slices=n_slices).numpy(), np.asarray(j.indices))
    np.testing.assert_allclose(t.quantized.numpy(), np.asarray(j.quantized),
                               atol=ATOL)
    for name in ("codebook_loss", "commit_loss"):
        np.testing.assert_allclose(float(getattr(t, name)),
                                   float(getattr(j, name)), atol=ATOL)


@pytest.mark.parametrize("group_axis", [None, 0])
@pytest.mark.parametrize("gsvq_cfg", [(1, 1), (16, 4)], ids=["vq", "gsvq"])
def test_split_public_private_matches_reference(group_axis, gsvq_cfg):
    n_groups, n_slices = gsvq_cfg
    rng = np.random.default_rng(7)
    z = (3.0 * rng.standard_normal((4, 16, 16)) + 1.0).astype(np.float32)
    cb = rng.standard_normal((64, 16)).astype(np.float32)
    j = jdis.split_public_private(jnp.asarray(z), jnp.asarray(cb),
                                  group_axis=group_axis, n_groups=n_groups,
                                  n_slices=n_slices)
    t = disentangle.split_public_private(_t(z), _t(cb),
                                         group_axis=group_axis,
                                         n_groups=n_groups,
                                         n_slices=n_slices)
    z_in = np.asarray(jdis.instance_norm_latent(jnp.asarray(z)))
    if n_groups == 1:
        assert _assert_codes(t.indices.numpy(), j.indices, z_in, cb) == 0
    else:
        np.testing.assert_array_equal(t.indices.numpy(),
                                      np.asarray(j.indices))
    for name in ("public", "private"):
        got, want = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=ATOL)
    for name in ("codebook_loss", "commit_loss", "latent_loss"):
        np.testing.assert_allclose(float(getattr(t, name)),
                                   float(getattr(j, name)), atol=ATOL)
    x = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    xr = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    jl, jr = jdis.total_loss(jnp.asarray(x), jnp.asarray(xr), j)
    tl, tr = disentangle.total_loss(_t(x), _t(xr), t)
    np.testing.assert_allclose([float(tl), float(tr)], [float(jl), float(jr)],
                               atol=ATOL)
    np.testing.assert_allclose(
        disentangle.recombine(t.public, t.private).numpy(),
        np.asarray(jdis.recombine(j.public, j.private)), atol=ATOL)
