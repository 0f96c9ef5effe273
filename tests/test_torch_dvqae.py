"""Port parity: layers, the weight converter and the image and speech
encoders against the JAX package, on parameters saved by the reference.

Tolerance atol 1e-4, rtol 1e-4 for float outputs: the two frameworks run
different convolution algorithms (sums in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.npz import _flatten_with_paths, save_pytree  # noqa: E402
from repro.core import octopus as JOC  # noqa: E402
from repro.core.disentangle import instance_norm_latent as j_in_latent  # noqa: E402
from repro.core.dvqae import DVQAEConfig as JConfig  # noqa: E402
from repro.core.dvqae import encode as j_encode  # noqa: E402
from repro.core.dvqae import init_dvqae  # noqa: E402
from repro.nn import layers as jl  # noqa: E402
from repro_torch.convert import init_numpy_params, load_npz  # noqa: E402
from repro_torch.core import octopus as OC  # noqa: E402
from repro_torch.core.disentangle import instance_norm_latent  # noqa: E402
from repro_torch.core.dvqae import DVQAEConfig, encode  # noqa: E402
from repro_torch.nn import layers  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


@pytest.mark.parametrize("size,ksize,stride", [
    (7, 3, 1), (8, 4, 2), (7, 4, 2), (9, 3, 2), (6, 1, 1)])
def test_conv2d_same_padding_matches_reference(size, ksize, stride):
    rng = np.random.default_rng(size * 10 + ksize)
    x = rng.standard_normal((2, size, size + 1, 3)).astype(np.float32)
    w = rng.standard_normal((ksize, ksize, 3, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    want = jl.conv2d({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)},
                     jnp.asarray(x), stride=stride)
    got = layers.conv2d(_t(x), _t(w.transpose(3, 2, 0, 1)), _t(b),
                        stride=stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("size,ksize,stride", [
    (11, 3, 1), (12, 4, 2), (11, 4, 2), (10, 1, 1)])
def test_conv1d_same_padding_matches_reference(size, ksize, stride):
    rng = np.random.default_rng(size * 10 + ksize)
    x = rng.standard_normal((2, size, 3)).astype(np.float32)
    w = rng.standard_normal((ksize, 3, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    want = jl.conv1d({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)},
                     jnp.asarray(x), stride=stride)
    got = layers.conv1d(_t(x), _t(w.transpose(2, 1, 0)), _t(b),
                        stride=stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_instance_norms_match_reference():
    rng = np.random.default_rng(0)
    x4 = rng.standard_normal((2, 5, 6, 3)).astype(np.float32) * 3 + 1
    x3 = rng.standard_normal((2, 7, 4)).astype(np.float32) * 3 + 1
    np.testing.assert_allclose(layers.instance_norm_2d(_t(x4)).numpy(),
                               np.asarray(jl.instance_norm_2d(
                                   jnp.asarray(x4))), **TOL)
    np.testing.assert_allclose(layers.instance_norm_1d(_t(x3)).numpy(),
                               np.asarray(jl.instance_norm_1d(
                                   jnp.asarray(x3))), **TOL)
    np.testing.assert_allclose(instance_norm_latent(_t(x3)).numpy(),
                               np.asarray(j_in_latent(jnp.asarray(x3))),
                               **TOL)


CASES = {
    "image": (dict(kind="image", in_channels=3, hidden=16, latent_dim=8,
                   codebook_size=16, n_res_blocks=1), (3, 16, 12, 3)),
    "speech": (dict(kind="speech", in_channels=5, hidden=16, latent_dim=8,
                    codebook_size=16, n_res_blocks=1), (3, 24, 5)),
}


@pytest.mark.parametrize("kind", sorted(CASES))
def test_encoder_matches_reference(tmp_path, kind):
    over, xshape = CASES[kind]
    jcfg, cfg = JConfig(**over), DVQAEConfig(**over)
    params = init_dvqae(jax.random.PRNGKey(1), jcfg)
    path = str(tmp_path / "p.npz")
    save_pytree(path, params)
    tparams = load_npz(path, cfg, device="cpu")
    x = np.random.default_rng(2).standard_normal(xshape).astype(np.float32)
    jz, jsp = j_encode(params, jcfg, jnp.asarray(x))
    with torch.no_grad():
        z, sp = encode(tparams, cfg, _t(x))
    assert sp == jsp
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), **TOL)
    jq, _ = JOC.client_encode(params, jcfg, jnp.asarray(x))
    q, _ = OC.client_encode(tparams, cfg, _t(x))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), **TOL)
    np.testing.assert_array_equal(tparams["codebook"].numpy(),
                                  np.asarray(params["codebook"]))


def _nest(flat):
    """Path-keyed arrays -> the reference's nested parameter dict."""
    out = {}
    for key, v in flat.items():
        *parents, leaf = key.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return out


@pytest.mark.parametrize("kind", sorted(CASES))
def test_numpy_init_has_reference_layout(kind):
    """init_numpy_params names and shapes every array of the reference's
    init -- encoder, decoder and codebook -- exactly as the reference
    does, so either package can load it; the JAX encoder and decoder run
    on those arrays match the port's."""
    from repro.core.dvqae import decode as j_decode
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.core.dvqae import decode
    over, xshape = CASES[kind]
    jcfg, cfg = JConfig(**over), DVQAEConfig(**over)
    ref_flat, _ = _flatten_with_paths(init_dvqae(jax.random.PRNGKey(0),
                                                 jcfg))
    flat = init_numpy_params(cfg, seed=3)
    assert {k: v.shape for k, v in flat.items()} == \
        {k: v.shape for k, v in ref_flat.items()}
    jparams = _nest(flat)
    tparams = params_from_numpy(flat, cfg, device="cpu")
    back = params_to_numpy(tparams)
    assert back.keys() == flat.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)
    x = np.random.default_rng(4).standard_normal(xshape).astype(np.float32)
    jz, sp = j_encode(jparams, jcfg, jnp.asarray(x))
    with torch.no_grad():
        z, _ = encode(tparams, cfg, _t(x))
        rec = decode(tparams, cfg, z, sp)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), **TOL)
    np.testing.assert_allclose(rec.numpy(),
                               np.asarray(j_decode(jparams, jcfg, jz, sp)),
                               **TOL)


def test_converters_need_an_explicit_cpu(tmp_path):
    """The DVQ-AE converters run on cuda unless asked for the CPU: without a
    GPU they raise and name ``device='cpu'``, and do not fall back."""
    from repro_torch.convert import (init_numpy_probe, params_from_numpy,
                                     probe_from_numpy)
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without a GPU")
    over, _ = CASES["image"]
    cfg = DVQAEConfig(**over)
    flat = init_numpy_params(cfg, seed=0)
    path = str(tmp_path / "p.npz")
    np.savez(path, **flat)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy(flat, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_npz(path, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe_from_numpy(init_numpy_probe(8, 3))
    # the same calls with device="cpu" load
    assert load_npz(path, cfg, device="cpu")["codebook"].device.type == "cpu"
    head = probe_from_numpy(init_numpy_probe(8, 3), device="cpu")
    assert next(head.parameters()).device.type == "cpu"
