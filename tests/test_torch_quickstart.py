"""The port's quickstart protocol and its data on the CPU.

The federated splits draw their permutations from
``numpy.random.default_rng`` in both packages, so on shared arrays they
must pick the same samples in the same order. The images themselves are
drawn from a ``torch.Generator`` in the port and from ``jax.random`` in
the reference, so ``run`` is held to behaviour: it completes, its
reconstruction loss falls, and one seed repeats it exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.data import federated as jfed  # noqa: E402
from repro.data.synthetic import LabeledData as JData  # noqa: E402
from repro.data.synthetic import _shape_stencils as j_stencils  # noqa: E402
from repro_torch.core.dvqae import DVQAEConfig  # noqa: E402
from repro_torch.data import federated  # noqa: E402
from repro_torch.data.synthetic import (LabeledData, _linspace,  # noqa: E402
                                        _shape_stencils, make_images)
from repro_torch.quickstart import run  # noqa: E402

SMALL = dict(hidden=32, latent_dim=16, codebook_size=32, n_res_blocks=1)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU tensors run far faster on one thread than on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shared(n=97):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, 4, 4, 3)).astype(np.float32)
    content = rng.integers(0, 8, n)
    style = rng.integers(0, 5, n)
    return (JData(jnp.asarray(x), jnp.asarray(content), jnp.asarray(style)),
            LabeledData(torch.from_numpy(x), torch.from_numpy(content),
                        torch.from_numpy(style)))


def _same(t: LabeledData, j: JData):
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("regime", ["iid", "worst", "skewed"])
def test_partition_matches_reference(regime):
    jd, td = _shared()
    jshards = jfed.partition(jd, 4, regime=regime, seed=3)
    tshards = federated.partition(td, 4, regime=regime, seed=3)
    assert len(tshards) == len(jshards) == 4
    for t, j in zip(tshards, jshards):
        _same(t, j)


def test_train_test_split_and_holdout_match_reference():
    jd, td = _shared()
    for t, j in zip(federated.train_test_split(td, 0.2),
                    jfed.train_test_split(jd, 0.2)):
        _same(t, j)
    for t, j in zip(federated.holdout_atd(td, 0.15),
                    jfed.holdout_atd(jd, 0.15)):
        _same(t, j)


@pytest.mark.parametrize("size", [8, 16, 17, 32, 64])
def test_shape_stencils_match_reference(size):
    """The glyphs agree wherever the pixel's coordinates agree bit for bit.
    ``jnp.linspace`` rounds some coordinates 1-2 ulp away from its own
    formula (and differently under jit), which moves a pixel that sits on
    a glyph edge; the port keeps the formula. At the quickstart's 32x32
    every pixel agrees."""
    want = np.asarray(j_stencils(size))
    got = _shape_stencils(size).numpy()
    assert got.shape == want.shape == (8, size, size)
    r = np.asarray(jnp.linspace(-1.0, 1.0, size))
    same = r == _linspace(size).numpy()
    mask = same[:, None] & same[None, :]
    np.testing.assert_array_equal(got[:, mask], want[:, mask])
    if size == 32:
        np.testing.assert_array_equal(got, want)


def test_make_images_shapes_and_factors():
    g = torch.Generator().manual_seed(0)
    d = make_images(g, 50, size=16, n_identities=4)
    assert tuple(d.x.shape) == (50, 16, 16, 3) and d.x.dtype == torch.float32
    assert int(d.content.max()) < 8 and int(d.style.max()) < 4
    again = make_images(torch.Generator().manual_seed(0), 50, size=16,
                        n_identities=4)
    for a, b in zip(d, again):
        assert torch.equal(a, b)


def test_quickstart_runs_learns_and_repeats():
    kw = dict(device="cpu", n_images=160, pretrain_steps=30, probe_steps=30,
              audit_steps=30)
    a = run(DVQAEConfig(**SMALL), **kw)
    losses = a["recon_losses"]
    assert len(losses) == 30 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert a["raw_bytes"] == a["n_train"] * 32 * 32 * 3 * 4
    assert 0 < a["uplink_bytes"] < a["raw_bytes"] / 100
    assert 0.0 <= a["content_accuracy"] <= 1.0
    assert a["reid_entropy_bits"] >= 0.0
    b = run(DVQAEConfig(**SMALL), **kw)
    assert a == b


def test_adversary_matches_reference_on_shared_weights():
    """The audit's probe, loss and Thm. 1 metrics on the reference's
    adversary weights: logits atol 1e-5, metrics rtol 1e-5."""
    import jax
    from repro.privacy import audit as jaudit
    from repro_torch.convert import probe_from_numpy
    from repro_torch.privacy import audit
    rng = np.random.default_rng(8)
    feats = rng.standard_normal((40, 6, 4)).astype(np.float32)
    labels = rng.integers(0, 5, 40)
    jadv = jaudit.init_adversary(jax.random.PRNGKey(2), 24, 5)
    adv = probe_from_numpy({k: np.array(v) for k, v in jadv.items()},
                           device="cpu")
    jf, jy = jnp.asarray(feats), jnp.asarray(labels)
    tf, ty = torch.from_numpy(feats), torch.from_numpy(labels)
    np.testing.assert_allclose(
        audit.adversary_logits(adv, tf).detach().numpy(),
        np.asarray(jaudit.adversary_logits(jadv, jf.reshape(40, -1))),
        atol=1e-5)
    np.testing.assert_allclose(float(audit.xent(adv, tf, ty)),
                               float(jaudit.xent(jadv, jf.reshape(40, -1),
                                                 jy)), rtol=1e-5)
    got = audit.evaluate_adversary(adv, tf, ty, 5)
    want = jaudit.evaluate_adversary(jadv, jf, jy, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    g = torch.Generator().manual_seed(0)
    pub, prv = audit.privacy_audit(g, tf, tf[:1], ty, 5, steps=5)
    assert 0.0 <= pub.accuracy <= 1.0 and prv.conditional_entropy_bits >= 0
