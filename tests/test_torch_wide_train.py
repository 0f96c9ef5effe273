"""Train steps at the flash backward's wide head dims against the JAX
package, on the CPU.

The SMOKE configs of gemma-7b, minicpm3-4b and deepseek-v3 widened to
their full configs' flash widths: gemma's head dim 256; MLA's q/k 96
(nope 64, rope 32, v 64: minicpm3-4b's) and 192 (nope 128, rope 64, v 128:
deepseek-v3's), where ``nn.attention.attend`` pads v to q/k's width. Both
packages start from the reference's ``init_lm`` weights and take two
steps on the same batches (the reference's ``build_train_step(...)[0]``
under ``jax.jit`` and a host mesh; the port's on the CPU, where its
``torch.library`` ops run the plain forward and backward versions). The
rules are ``tests/test_torch_lm_train.py``'s: losses within 1e-5
relative; after the warmup's step (learning rate 0) the parameters as
they were, after the second each within 1e-4 absolute; AdamW's moments
within
1e-5 of each leaf's largest element.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.npz import _flatten_with_paths  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.distributed import steps as JS  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim.adamw import adamw_init as jadamw_init  # noqa: E402
from repro_torch.configs import TrainConfig, smoke_config  # noqa: E402
from repro_torch.convert import (lm_params_from_numpy,  # noqa: E402
                                 lm_params_to_numpy)
from repro_torch.distributed import steps as S  # noqa: E402
from repro_torch.nn.attention import flash_width  # noqa: E402

B, L = 2, 16
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4
MOMENT_RTOL = 1e-5
TRAJ_KW = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
               weight_decay=0.5)
#: arch -> the flash width its widened SMOKE config trains at
WIDTHS = {"gemma_7b": 256, "minicpm3_4b": 96, "deepseek_v3_671b": 192}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _widened(cfg, arch):
    if not cfg.use_mla:
        return cfg.replace(head_dim=256)
    nope, rope, v = (64, 32, 64) if arch == "minicpm3_4b" else (128, 64, 128)
    return cfg.replace(mla=dataclasses.replace(
        cfg.mla, qk_nope_head_dim=nope, qk_rope_head_dim=rope, v_head_dim=v))


def _tokens(seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, L)) \
        .astype(np.int32)


def _tree_like(params, flat):
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v) for v in node]
        return next(it)

    return build(params)


def _close_per_leaf(got, want, rtol, what):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        w = np.asarray(w)
        err = float(np.abs(got[key] - w).max())
        top = float(np.abs(w).max())
        assert err <= rtol * top or err == 0.0, \
            f"{what} {key}: {err} of {top}"


_TRAJECTORIES = {}


def _trajectory(arch):
    if arch in _TRAJECTORIES:
        return _TRAJECTORIES[arch]
    jcfg = _widened(jsmoke_config(arch), arch)
    cfg = _widened(smoke_config(arch), arch)
    width = (flash_width(cfg.mla.qk_head_dim, cfg.mla.v_head_dim)
             if cfg.use_mla else cfg.resolved_head_dim)
    assert width == WIDTHS[arch]
    jp = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    flat = _flatten_with_paths(jp)[0]
    mesh = make_host_mesh()
    jstep = jax.jit(JS.build_train_step(jcfg, JTrainConfig(**TRAJ_KW),
                                        mesh, ShapeConfig("test", L, B,
                                                          "train"))[0])
    jstate = JS.TrainState(params=jp, opt=jadamw_init(jp),
                           step=jnp.zeros((), jnp.int32))
    state = S.init_train_state(lm_params_from_numpy(flat, cfg, device="cpu"))
    step = S.build_train_step(cfg, TrainConfig(**TRAJ_KW))
    out = []
    for i in range(2):
        toks = _tokens(20 + i, cfg.vocab_size)
        with mesh:
            jstate, jloss = jstep(jstate, {"tokens": jnp.asarray(toks)})
        state, loss = step(state, {"tokens": torch.from_numpy(toks)})

        def port_side(tree):
            # copies: the port updates in place, .numpy() shares memory
            return {k: v.copy() for k, v in
                    lm_params_to_numpy(tree, cfg).items()}

        out.append({
            "ref": (float(jloss), _flatten_with_paths(jstate.params)[0],
                    _flatten_with_paths(jstate.opt.mu)[0],
                    _flatten_with_paths(jstate.opt.nu)[0]),
            "port": (float(loss), port_side(state.params),
                     port_side(_tree_like(state.params, state.opt.mu)),
                     port_side(_tree_like(state.params, state.opt.nu)))})
    _TRAJECTORIES[arch] = (flat, out)
    return _TRAJECTORIES[arch]


@pytest.mark.parametrize("n_steps", [1, 2])
@pytest.mark.parametrize("arch", sorted(WIDTHS))
def test_widened_train_steps_match_reference(arch, n_steps):
    initial, traj = _trajectory(arch)
    (jloss, jparams, jmu, jnu) = traj[n_steps - 1]["ref"]
    (loss, params, mu, nu) = traj[n_steps - 1]["port"]
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    assert sorted(params) == sorted(jparams)
    for key, want in jparams.items():
        if n_steps == 1:             # the warmup's learning rate is 0
            np.testing.assert_array_equal(params[key], initial[key])
            continue
        np.testing.assert_allclose(params[key], np.asarray(want), rtol=0,
                                   atol=PARAM_ATOL, err_msg=key)
    _close_per_leaf(mu, jmu, MOMENT_RTOL, "mu")
    _close_per_leaf(nu, jnu, MOMENT_RTOL, "nu")
