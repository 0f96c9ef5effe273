"""Port parity: whisper-base training (an encoder-decoder's train step).

The reference's ``build_train_step`` encodes ``batch["frames"]`` with
``encode_audio`` and takes ``lm_loss(..., enc_out=...)`` under
``jax.value_and_grad``; the port's does the same under autograd, and the
gradient reaches the encoder through cross-attention's keys and values
(the flash backward at Tq != Tk on the card). At the ``SMOKE`` config (2
encoder and 2 decoder layers, d 256, 4 heads of 64, 64 frames), on the
reference's own weights carried across by ``repro_torch.convert``, frames
and tokens from numpy:

* the loss and every parameter's gradient, remat on and off, against
  ``jax.value_and_grad`` of the reference's loss;
* 1 and 3 train steps against the reference's ``build_train_step(...)[0]``
  called eagerly on a host mesh (as ``tests/test_torch_lm_train.py`` runs
  it);
* a step on the card, patched here with counted plain versions: the flash
  forward and backward calls by shape (the encoder's once forward, the
  decoder's self- and cross-attention twice with remat, each backward
  once);
* ``launch/train.py --arch whisper-base --smoke --device cpu``, its loss
  falling, and its frames.

Tolerances are ``tests/test_torch_lm_train.py``'s: the loss within 1e-5
relative, each gradient within 1e-4 of its leaf's largest element, after
AdamW steps the parameters within 1e-4 absolute and the moments within
1e-5 of each leaf's largest element.
"""
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
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import bwd_plan  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402

ARCH = "whisper_base"
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_ATOL = 1e-4
MOMENT_RTOL = 1e-5
B, L = 2, 16
TRAJ_KW = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
               weight_decay=0.5)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU tensors run far faster on one thread than on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_TWINS = {}


def _twins():
    """The reference's SMOKE config and weights, the port's config and the
    flat arrays."""
    if not _TWINS:
        jcfg = jsmoke_config(ARCH)
        jp = JT.init_lm(jax.random.PRNGKey(0), jcfg)
        _TWINS.update(jcfg=jcfg, jp=jp, cfg=smoke_config(ARCH),
                      flat=_flatten_with_paths(jp)[0])
    return _TWINS


def _batch(seed):
    """(tokens (B, L) int32, frames (B, n_frames, d) float32) from numpy."""
    cfg = _twins()["cfg"]
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (B, L)).astype(np.int32),
            rng.standard_normal((B, cfg.n_audio_frames, cfg.d_model))
            .astype(np.float32))


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


def _port_loss_grads(toks, frames, remat):
    tw = _twins()
    cfg = tw["cfg"]
    params = lm_params_from_numpy(tw["flat"], cfg, device="cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    enc = T.encode_audio(params, cfg, torch.from_numpy(frames))
    loss = T.lm_loss(params, cfg, torch.from_numpy(toks), enc_out=enc,
                     remat=remat)
    grads = torch.autograd.grad(loss, leaves(params))
    return float(loss.detach()), lm_params_to_numpy(
        _tree_like(params, grads), cfg)


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_gradients_match_reference(remat):
    """Every parameter's gradient, the encoder's too (through
    cross-attention's keys and values)."""
    tw = _twins()
    toks, frames = _batch(3)

    def loss_fn(p):
        enc = JT.encode_audio(p, tw["jcfg"], jnp.asarray(frames))
        return JT.lm_loss(p, tw["jcfg"], jnp.asarray(toks), enc_out=enc,
                          remat=remat)

    want, jgrads = jax.value_and_grad(loss_fn)(tw["jp"])
    got, grads = _port_loss_grads(toks, frames, remat)
    np.testing.assert_allclose(got, float(want), rtol=LOSS_RTOL)
    jflat = _flatten_with_paths(jgrads)[0]
    _close_per_leaf(grads, jflat, GRAD_RTOL, "gradient")
    encoder = [k for k in grads if k.startswith("encoder")]
    assert encoder and all(np.abs(grads[k]).max() > 0 for k in encoder)


def test_remat_on_and_off_agree():
    toks, frames = _batch(4)
    loss_on, on = _port_loss_grads(toks, frames, True)
    loss_off, off = _port_loss_grads(toks, frames, False)
    assert loss_on == loss_off
    _close_per_leaf(on, off, 1e-6, "remat on vs off")


_TRAJECTORY = []


def _trajectory():
    """Three train steps of each package from the same weights on the same
    batches: after each, (loss, step, params, mu, nu, count) of both."""
    if _TRAJECTORY:
        return _TRAJECTORY
    tw = _twins()
    jcfg, cfg = tw["jcfg"], tw["cfg"]
    mesh = make_host_mesh()
    jstep = JS.build_train_step(jcfg, JTrainConfig(**TRAJ_KW), mesh,
                                ShapeConfig("test", L, B, "train"))[0]
    jstate = JS.TrainState(params=tw["jp"], opt=jadamw_init(tw["jp"]),
                           step=jnp.zeros((), jnp.int32))
    state = S.init_train_state(lm_params_from_numpy(tw["flat"], cfg,
                                                    device="cpu"))
    step = S.build_train_step(cfg, TrainConfig(**TRAJ_KW))

    def port_side(tree):
        # copies: the port updates in place, and .numpy() shares memory
        return {k: v.copy() for k, v in
                lm_params_to_numpy(tree, cfg).items()}

    for i in range(3):
        toks, frames = _batch(10 + i)
        with mesh:
            jstate, jloss = jstep(jstate, {"tokens": jnp.asarray(toks),
                                           "frames": jnp.asarray(frames)})
        state, loss = step(state, {"tokens": torch.from_numpy(toks),
                                   "frames": torch.from_numpy(frames)})
        _TRAJECTORY.append({
            "ref": (float(jloss), int(jstate.step),
                    _flatten_with_paths(jstate.params)[0],
                    _flatten_with_paths(jstate.opt.mu)[0],
                    _flatten_with_paths(jstate.opt.nu)[0],
                    int(jstate.opt.count)),
            "port": (float(loss), state.step, port_side(state.params),
                     port_side(_tree_like(state.params, state.opt.mu)),
                     port_side(_tree_like(state.params, state.opt.nu)),
                     state.opt.count)})
    return _TRAJECTORY


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_reference(n_steps):
    after = _trajectory()[n_steps - 1]
    (jloss, jstep, jparams, jmu, jnu, jcount) = after["ref"]
    (loss, step, params, mu, nu, count) = after["port"]
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    assert step == jstep == count == jcount == n_steps
    assert sorted(params) == sorted(jparams)
    initial = _twins()["flat"]
    for key, want in jparams.items():
        if n_steps == 1:             # the warmup's learning rate is 0
            np.testing.assert_array_equal(np.asarray(want), initial[key])
            np.testing.assert_array_equal(params[key], initial[key])
            continue
        np.testing.assert_allclose(params[key], np.asarray(want), rtol=0,
                                   atol=PARAM_ATOL, err_msg=key)
    _close_per_leaf(mu, jmu, MOMENT_RTOL, "mu")
    _close_per_leaf(nu, jnu, MOMENT_RTOL, "nu")


@pytest.mark.parametrize("remat", [True, False])
def test_step_on_the_card_calls_the_flash_kernels_by_shape(monkeypatch,
                                                           remat):
    """``ops._on_card`` patched, the flash wrappers counted plain versions
    that record (Tq, Tk, causal): the encoder's self-attention once
    forward, the decoder's causal self-attention and cross-attention (L
    queries over the frames) once a layer, twice with remat; each
    backward once, its batch slices and ranges as bwd_plan says."""
    seen = []

    def flash(q, k, v, *, causal, window, return_lse=False):
        seen.append(("fwd", q.shape[1], k.shape[1], causal))
        o = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        if not return_lse:
            return o
        return o, ref.flash_attention_lse_ref(q, k, v, causal=causal,
                                              window=window)

    def flash_bwd(q, k, v, o, lse, do, *, causal, window):
        seen.append(("bwd", q.shape[1], k.shape[1], causal))
        return ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                           causal=causal, window=window)

    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(ops, "flash_attention_cuda", flash)
    monkeypatch.setattr(ops, "flash_attention_bwd_cuda", flash_bwd)
    tw = _twins()
    cfg = tw["cfg"]
    state = S.init_train_state(lm_params_from_numpy(tw["flat"], cfg,
                                                    device="cpu"))
    toks, frames = _batch(5)
    _, loss = S.build_train_step(cfg, TrainConfig(remat=remat, **TRAJ_KW))(
        state, {"tokens": torch.from_numpy(toks),
                "frames": torch.from_numpy(frames)})
    assert bool(torch.isfinite(loss))
    F, fwd = cfg.n_audio_frames, 2 if remat else 1
    want = {("fwd", F, F, False): cfg.n_encoder_layers,
            ("fwd", L, L, True): fwd * cfg.n_layers,
            ("fwd", L, F, False): fwd * cfg.n_layers,
            ("bwd", F, F, False): cfg.n_encoder_layers,
            ("bwd", L, L, True): cfg.n_layers,
            ("bwd", L, F, False): cfg.n_layers}
    assert {k: seen.count(k) for k in set(seen)} == want
    # one launch a backward call at these shapes
    assert all(bwd_plan(B, Tq, Tk, cfg.n_heads, c)[:2] == (B, [(0, Tq)])
               for _, Tq, Tk, c in set(seen))


def test_launcher_trains_whisper_on_cpu(capsys):
    """``--arch whisper-base --smoke``: 12 steps with frames, the last
    logged loss below the first."""
    state, losses = train.main(["--arch", "whisper-base", "--smoke",
                                "--device", "cpu", "--steps", "12",
                                "--batch", "2", "--seq", "16",
                                "--log-every", "11"])
    logged = [float(line.split("loss")[1].split()[0]) for line in
              capsys.readouterr().out.splitlines()
              if line.startswith("step")]
    assert len(logged) == 2 and logged[-1] < logged[0], logged
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert state.step == 12


def test_launcher_frames():
    """Step i's frames: N(0, 1) float32 (B, n_frames, d) from a CPU
    generator seeded by (seed, i), the same on every call, another a
    step."""
    cfg = smoke_config(ARCH)
    a = train.frames_at(3, 5, 2, cfg, "cpu")
    g = torch.Generator().manual_seed((3 << 32) + 5)
    assert a.dtype == torch.float32
    assert tuple(a.shape) == (2, cfg.n_audio_frames, cfg.d_model)
    assert torch.equal(a, torch.randn(tuple(a.shape), generator=g))
    assert torch.equal(a, train.frames_at(3, 5, 2, cfg, "cpu"))
    assert not torch.equal(a, train.frames_at(3, 6, 2, cfg, "cpu"))
