"""Port parity of the training path: the transposed conv, the DVQ-AE
decoders and Eq. 6 forward, one pretraining and one fine-tuning step,
AdamW, and a client round with its default fine-tuning step.

Parameters pass from the reference's init through ``save_pytree`` and
``convert.load_npz``; inputs come from ``numpy.random.default_rng``. The
JAX side runs its Pallas VQ kernel in interpret mode, as its own tests do.

Tolerances: convolutions atol 1e-5; recon atol 1e-5, loss rtol 1e-5;
gradients rtol 1e-4, atol 1e-6 leaf by leaf, after asserting that the
step's codes agree; AdamW on shared gradients atol 1e-7. Parameters after
an AdamW step are compared within 2*lr: the first step moves a parameter
by about lr*sign(g), so float noise in a near-zero gradient can flip it.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.npz import _flatten_with_paths, save_pytree  # noqa: E402
from repro.core import octopus as JOC  # noqa: E402
from repro.core.dvqae import DVQAEConfig as JConfig  # noqa: E402
from repro.core.dvqae import forward as _j_forward  # noqa: E402
from repro.core.dvqae import init_dvqae  # noqa: E402
from repro.nn import layers as jl  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.wire.session import OctopusServer as JServer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import octopus as OC  # noqa: E402
from repro_torch.core.dvqae import DVQAEConfig, forward  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.nn import layers  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.wire.session import OctopusServer  # noqa: E402

SMALL = dict(hidden=32, latent_dim=16, codebook_size=32, n_res_blocks=1)
SPEECH = dict(kind="speech", in_channels=5, hidden=16, latent_dim=8,
              codebook_size=16, n_res_blocks=1)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
j_forward = jax.jit(_j_forward, static_argnums=1)


def j_loss_and_grads(params, jcfg, x, keys=("encoder", "decoder",
                                            "codebook")):
    """The reference's Eq. 6 loss, its DVQAEOut and its gradients with
    respect to ``keys`` (the rest held fixed), in one jitted call."""
    train = {k: params[k] for k in keys}
    rest = {k: v for k, v in params.items() if k not in keys}
    (_, out), grads = _j_value_and_grad(train, rest, jcfg, x)
    return out, grads


@functools.partial(jax.jit, static_argnums=2)
def _j_value_and_grad(train, rest, jcfg, x):
    def loss(train):
        out = _j_forward({**rest, **train}, jcfg, x)
        return out.loss, out

    return jax.value_and_grad(loss, has_aux=True)(train)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU tensors run far faster on one thread than on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def twins(tmp_path, over, seed=0):
    """Reference parameters and the port's copy of them (CPU)."""
    jcfg, cfg = JConfig(**over), DVQAEConfig(**over)
    jparams = jax.jit(init_dvqae, static_argnums=1)(
        jax.random.PRNGKey(seed), jcfg)
    path = str(tmp_path / "params.npz")
    save_pytree(path, jparams)
    return jparams, convert.load_npz(path, cfg, device="cpu"), jcfg, cfg


def flat(tree):
    return _flatten_with_paths(tree)[0]


def port_grads(tparams, grads):
    """Port gradients in leaf order -> reference keys and layouts."""
    return {k: convert.to_reference_layout(g)
            for (k, _), g in zip(convert.named_leaves(tparams), grads)}


def assert_codes_agree(t_idx, j_idx, z, cb):
    z = np.asarray(z, np.float64).reshape(-1, np.shape(cb)[-1])
    cb = np.asarray(cb, np.float64)
    scores = torch.from_numpy((cb * cb).sum(-1)[None] - 2 * z @ cb.T)
    n_diff, n_out = ref.code_mismatches(
        t_idx, torch.from_numpy(np.array(j_idx)), scores)
    assert n_out == 0, f"{n_out} codes differ outside the near-tie rule"
    return n_diff


def assert_tree_close(got: dict, want: dict, **tol):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), err_msg=k,
                                   **tol)


@pytest.mark.parametrize("size", [5, 8])
@pytest.mark.parametrize("ksize,stride", [(3, 1), (3, 2), (4, 1), (4, 2)])
def test_conv2d_transpose_matches_reference(size, ksize, stride):
    rng = np.random.default_rng(size * 10 + ksize + stride)
    x = rng.standard_normal((2, size, size + 1, 3)).astype(np.float32)
    w = rng.standard_normal((ksize, ksize, 3, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    want = jl.conv2d_transpose({"kernel": jnp.asarray(w),
                                "bias": jnp.asarray(b)}, jnp.asarray(x),
                               stride=stride)
    got = layers.conv2d_transpose(_t(x), _t(w.transpose(3, 2, 0, 1)), _t(b),
                                  stride=stride)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("over,xshape", [(SMALL, (3, 16, 16, 3)),
                                         (SPEECH, (3, 24, 5))],
                         ids=["image", "speech"])
def test_forward_matches_reference(tmp_path, over, xshape):
    jparams, tparams, jcfg, cfg = twins(tmp_path, over)
    x = np.random.default_rng(2).standard_normal(xshape).astype(np.float32)
    j = j_forward(jparams, jcfg, jnp.asarray(x))
    with torch.no_grad():
        t = forward(tparams, cfg, _t(x))
    assert t.latent.indices.dtype == torch.int32
    np.testing.assert_array_equal(t.latent.indices.numpy(),
                                  np.asarray(j.latent.indices))
    np.testing.assert_allclose(t.recon.numpy(), np.asarray(j.recon),
                               atol=1e-5)
    np.testing.assert_allclose(float(t.loss), float(j.loss), rtol=1e-5)
    np.testing.assert_allclose(float(t.recon_loss), float(j.recon_loss),
                               rtol=1e-5)


def test_pretrain_step_matches_reference(tmp_path):
    """Gradients of every leaf, codebook included, then the AdamW step."""
    jparams, tparams, jcfg, cfg = twins(tmp_path, SMALL)
    x = np.random.default_rng(3).random((4, 16, 16, 3), dtype=np.float32)
    jx = jnp.asarray(x)
    jout, jgrads = j_loss_and_grads(jparams, jcfg, jx)
    grads, out = OC.loss_grads(tparams, cfg, _t(x))
    jz, _ = JOC.client_encode(jparams, jcfg, jx)
    assert assert_codes_agree(out.latent.indices, jout.latent.indices, jz,
                              jparams["codebook"]) == 0
    np.testing.assert_allclose(float(out.loss), float(jout.loss), rtol=1e-5)
    assert_tree_close(port_grads(tparams, grads), flat(jgrads), **GRAD_TOL)

    # the reference's server_pretrain_step: adamw_update of these gradients
    jnew, _ = jadamw.adamw_update(jparams, jgrads,
                                  jadamw.adamw_init(jparams), lr=1e-3)
    tstate, to = OC.server_pretrain_step(
        OC.ServerState(params=tparams), cfg, _t(x))
    assert tstate.step == 1 and tstate.opt.count == 1
    np.testing.assert_allclose(float(to.loss), float(jout.loss), rtol=1e-5)
    assert_tree_close(convert.params_to_numpy(tstate.params), flat(jnew),
                      atol=2e-3 + 1e-6, rtol=0)
    # the first moment is (1 - b1) * g
    mu = port_grads(tparams, tstate.opt.mu)
    assert_tree_close(mu, {k: 0.1 * np.asarray(v)
                           for k, v in flat(jgrads).items()}, **GRAD_TOL)


def test_finetune_step_matches_reference(tmp_path):
    """Encoder and decoder gradients and step; the codebook stays frozen."""
    jparams, tparams, jcfg, cfg = twins(tmp_path, SMALL, seed=1)
    x = np.random.default_rng(4).random((4, 16, 16, 3), dtype=np.float32)
    jx = jnp.asarray(x)

    _, jgrads = j_loss_and_grads(jparams, jcfg, jx, ("encoder", "decoder"))
    grads, _ = OC.loss_grads(tparams, cfg, _t(x),
                             keys=("encoder", "decoder"))
    assert len(grads) == len(convert.named_leaves(tparams)) - 1
    got = port_grads(tparams, grads)
    assert_tree_close(got, flat(jgrads), **GRAD_TOL)

    jclient, _, jo = JOC.client_finetune_step(
        JOC.client_init(JOC.ServerState(params=jparams, opt=None,
                                        step=jnp.zeros((), jnp.int32))),
        jcfg, jx)
    client = OC.client_init(OC.ServerState(params=tparams))
    cb0 = client.params["codebook"].clone()
    client, opt, to = OC.client_finetune_step(client, cfg, _t(x))
    assert client.step == 1 and opt.count == 1
    np.testing.assert_allclose(float(to.loss), float(jo.loss), rtol=1e-5)
    assert torch.equal(client.params["codebook"], cb0)
    assert_tree_close(convert.params_to_numpy(client.params),
                      flat(jclient.params), atol=2e-4 + 1e-6, rtol=0)
    # the client trained its own copies: the deployed model did not move
    np.testing.assert_array_equal(
        convert.params_to_numpy(tparams)["encoder/down1/kernel"],
        np.asarray(jparams["encoder"]["down1"]["kernel"]))


def test_adamw_matches_reference_on_shared_gradients():
    rng = np.random.default_rng(5)
    shapes = {"a": (3, 4), "b": (7,), "c": (2, 3, 5)}
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    gs = [{k: (rng.standard_normal(s) * 10.0 ** rng.integers(-6, 1))
           .astype(np.float32) for k, s in shapes.items()}
          for _ in range(3)]
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jst = jadamw.adamw_init(jp)
    tp = {k: _t(v) for k, v in p.items()}
    tst = adamw.adamw_init(tp)
    for i, g in enumerate(gs):
        kw = dict(lr=1e-3, grad_clip=1.0 if i == 2 else 0.0,
                  weight_decay=0.1 if i == 1 else 0.0)
        jp, jst = jadamw.adamw_update(jp, {k: jnp.asarray(v)
                                           for k, v in g.items()}, jst, **kw)
        tp, tst = adamw.adamw_update(tp, {k: _t(v) for k, v in g.items()},
                                     tst, **kw)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-7, rtol=0, err_msg=k)
    assert tst.count == int(jst.count) == 3
    g = {k: _t(v) for k, v in gs[0].items()}
    np.testing.assert_allclose(
        float(adamw.global_norm(g)),
        float(jadamw.global_norm({k: jnp.asarray(v)
                                  for k, v in gs[0].items()})), rtol=1e-6)
    clipped, norm = adamw.clip_by_global_norm(g, 0.5)
    np.testing.assert_allclose(float(adamw.global_norm(clipped)),
                               min(0.5, float(norm)), rtol=1e-6)


def test_round_fine_tunes_one_step_by_default(tmp_path):
    """A bare round(batch): one fine-tuning step with agreeing gradients,
    the same codes, and the Step 5 refresh, in both packages."""
    jparams, tparams, jcfg, cfg = twins(tmp_path, SMALL)
    jsrv = JServer(JOC.ServerState(params=jparams,
                                   opt=jadamw.adamw_init(jparams),
                                   step=jnp.zeros((), jnp.int32)), jcfg)
    srv = OctopusServer(OC.ServerState(params=tparams), cfg, device="cpu")
    x = np.random.default_rng(6).random((4, 16, 16, 3), dtype=np.float32)
    jx = jnp.asarray(x)
    jc, tc = jsrv.deploy(), srv.deploy()
    assert (tc.lr, tc.gamma, tc.n_local_steps) == (jc.lr, jc.gamma,
                                                   jc.n_local_steps)

    jp0 = jc.state.params
    _, jgrads = j_loss_and_grads(jp0, jcfg, jx, ("encoder", "decoder"))
    grads, _ = OC.loss_grads(tc.state.params, cfg, _t(x),
                             keys=("encoder", "decoder"))
    got = port_grads(tc.state.params, grads)
    assert_tree_close(got, flat(jgrads), **GRAD_TOL)

    jp = jc.round(jx)
    tp = tc.round(x)
    assert int(jc.state.step) == tc.state.step == 1
    jz, _ = JOC.client_encode(jc.state.params, jcfg, jx)
    n_diff = assert_codes_agree(tp.unpack().reshape(-1), jp.unpack(), jz,
                                jp0["codebook"])
    assert n_diff <= 1e-3 * tp.count
    port = convert.params_to_numpy(tc.state.params)
    ref_params = flat(jc.state.params)
    for k in ref_params:
        if k != "codebook":
            np.testing.assert_allclose(port[k], ref_params[k],
                                       atol=2e-4 + 1e-6, rtol=0, err_msg=k)
    if n_diff == 0:
        np.testing.assert_allclose(tc.codebook.numpy(),
                                   np.asarray(jc.codebook), rtol=1e-5,
                                   atol=1e-5)
    # finetune=0 and finetune=2 override the session's one step
    tc.round(x, finetune=2)
    assert tc.state.step == 3
    tc.transmit(x)
    assert tc.state.step == 3


def test_pretrain_repins_the_registry_and_carries_the_moments(tmp_path):
    _, tparams, _, cfg = twins(tmp_path, SMALL)
    srv = OctopusServer(OC.server_init(0, cfg, device="cpu"), cfg,
                        device="cpu")
    x = np.random.default_rng(7).random((40, 16, 16, 3), dtype=np.float32)
    g = torch.Generator().manual_seed(0)
    cb0 = srv.registry.get(0).clone()
    out = srv.pretrain(g, x, steps=2, batch=8)
    assert srv.state.step == 2 and srv.state.opt.count == 2
    assert tuple(out.recon.shape) == (8, 16, 16, 3)
    assert not torch.equal(srv.registry.get(0), cb0)
    assert torch.equal(srv.registry.get(0), srv.state.params["codebook"])
    srv.pretrain(g, x, steps=1, batch=8)
    assert srv.state.opt.count == 3 and srv.version == 0
    # the same generator seed repeats the same minibatches
    again = OctopusServer(OC.server_init(0, cfg, device="cpu"), cfg,
                          device="cpu")
    again.pretrain(torch.Generator().manual_seed(0), x, steps=3, batch=8)
    assert torch.equal(again.state.params["codebook"],
                       srv.state.params["codebook"])
    srv.ingest(srv.deploy().transmit(x[:2]))
    with pytest.raises(RuntimeError, match="pretrain before ingesting"):
        srv.pretrain(g, x, steps=1)
