"""Port parity: LM training (schedules, ``lm_loss`` with and without remat,
its gradients, the one-device train step, the launcher and the LM-on-codes
script) against the JAX package on shared weights and tokens.

Weights are the reference's own ``init_lm`` arrays, carried into the port
through ``repro_torch.convert``; tokens come from numpy. Sizes are the
qwen3 and jamba ``SMOKE`` configs (jamba: Mamba mixers, an attention
layer, MoE feed-forwards with their aux loss).

The reference's train step is ``repro.distributed.steps.build_train_step
(...)[0]`` called eagerly on a host mesh: its sharded ``jit`` (what
``python -m repro.launch.train`` runs) raises ``ShardingTypeError`` on the
embedding gather under this JAX, the step function itself does not.

Tolerances: schedules within 2.4e-7 relative (2 float32 ulps: the two
packages' float32 ``cos`` may round apart by one); losses 1e-5 relative;
each parameter's gradient within 1e-4 of its leaf's largest element
(float32 sums in another order); after AdamW steps, parameters within
1e-4 absolute (a tenth of the learning rate: AdamW moves an element by
about lr * sign(g), so only a sign that differs could exceed it, which no
element of these seeds has) and each moment within 1e-5 of its leaf's
largest element. The trajectories take a weight decay of 0.5, whose term
on the norms' unit scales (lr * 0.5 = 5e-4 a step) is five times the
parameter tolerance; their warmup gives the first step a learning rate of
0, so after it the parameters must be exactly the initial ones. One step
past warmup is held apart: the port's step against the reference's
``adamw_update`` and schedule applied to the port's own gradient, within
2.5e-7 absolute (two float32 ulps at the unit scales); the same gradient
on both sides, so a near-zero gradient, where AdamW's step g / (|g| + eps)
turns on the gradient's last bits, cannot hide a wiring error.
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
from repro.optim import schedules as jsched  # noqa: E402
from repro.optim.adamw import adamw_init as jadamw_init  # noqa: E402
from repro.optim.adamw import adamw_update as jadamw_update  # noqa: E402
from repro_torch import train_lm_on_codes  # noqa: E402
from repro_torch.checkpoint import npz  # noqa: E402
from repro_torch.configs import TrainConfig, smoke_config  # noqa: E402
from repro_torch.convert import (lm_params_from_numpy,  # noqa: E402
                                 lm_params_to_numpy)
from repro_torch.distributed import steps as S  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import schedules  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402

SCHED_RTOL = 2.4e-7
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_ATOL = 1e-4
MOMENT_RTOL = 1e-5
ARCHS = ("qwen3-0.6b", "jamba-v0.1-52b")
B, L = 2, 24
STEP_KW = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
TRAJ_KW = dict(STEP_KW, weight_decay=0.5)
ADAMW_ATOL = 2.5e-7


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU tensors run far faster on one thread than on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_TWINS = {}


def _twins(arch):
    """The reference's SMOKE config and weights; the port's config and the
    flat arrays."""
    if arch not in _TWINS:
        jcfg = jsmoke_config(arch)
        jp = JT.init_lm(jax.random.PRNGKey(0), jcfg)
        _TWINS[arch] = (jcfg, jp, smoke_config(arch),
                        _flatten_with_paths(jp)[0])
    return _TWINS[arch]


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
    """Every array of ``want`` (path-keyed) within ``rtol`` of its largest
    element in ``got``."""
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        w = np.asarray(w)
        err = float(np.abs(got[key] - w).max())
        top = float(np.abs(w).max())
        assert err <= rtol * top or err == 0.0, \
            f"{what} {key}: {err} of {top}"


# --------------------------------------------------------------- schedules

SCHEDULES = [dict(base_lr=3e-4, warmup_steps=10, total_steps=30),
             dict(base_lr=1e-3, warmup_steps=1, total_steps=20),
             dict(base_lr=3e-4, warmup_steps=0, total_steps=25,
                  min_ratio=0.2)]


@pytest.mark.parametrize("kind", ["cosine", "constant"])
@pytest.mark.parametrize("kw", SCHEDULES)
def test_schedules_match_reference(kind, kw):
    """Steps 0-30 across the warmup edge, on ints and on 0-d tensors."""
    if kind == "constant":
        kw = dict(base_lr=kw["base_lr"], warmup_steps=kw["warmup_steps"])
    ours = schedules.warmup_cosine if kind == "cosine" \
        else schedules.warmup_constant
    theirs = jsched.warmup_cosine if kind == "cosine" \
        else jsched.warmup_constant
    for step in range(31):
        want = np.float32(theirs(jnp.int32(step), **kw))
        for arg in (step, torch.tensor(step, dtype=torch.int32)):
            got = ours(arg, **kw)
            assert got.dtype == torch.float32 and got.shape == ()
            np.testing.assert_allclose(float(got), want, rtol=SCHED_RTOL,
                                       atol=0, err_msg=f"step {step}")


# ----------------------------------------------------------- loss, grads

def _port_loss_grads(arch, toks, remat):
    _, _, cfg, flat = _twins(arch)
    params = lm_params_from_numpy(flat, cfg, device="cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    loss = T.lm_loss(params, cfg, torch.from_numpy(toks), remat=remat)
    grads = torch.autograd.grad(loss, leaves(params), allow_unused=True,
                                materialize_grads=True)
    return float(loss.detach()), lm_params_to_numpy(
        _tree_like(params, grads), cfg)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradients_match_reference(arch, remat):
    jcfg, jp, cfg, _ = _twins(arch)
    toks = _tokens(3, cfg.vocab_size)
    want, jgrads = jax.value_and_grad(lambda p: JT.lm_loss(
        p, jcfg, jnp.asarray(toks), remat=remat))(jp)
    got, grads = _port_loss_grads(arch, toks, remat)
    np.testing.assert_allclose(got, float(want), rtol=LOSS_RTOL)
    _close_per_leaf(grads, _flatten_with_paths(jgrads)[0], GRAD_RTOL,
                    "gradient")


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_and_off_agree(arch):
    """Recomputing each block in the backward changes no gradient."""
    toks = _tokens(4, _twins(arch)[2].vocab_size)
    loss_on, on = _port_loss_grads(arch, toks, True)
    loss_off, off = _port_loss_grads(arch, toks, False)
    assert loss_on == loss_off
    _close_per_leaf(on, off, 1e-6, "remat on vs off")


def test_remat_recomputes_the_kernels_once_more(monkeypatch):
    """On the card (patched here with counted plain versions), a remat
    step runs each block's rmsnorm and flash_attention forward twice and
    each backward kernel once: 4 norms and 1 attention a block, the final
    norm once."""
    from repro_torch.kernels import ops, ref
    counts = {"rmsnorm": 0, "flash_attention": 0, "rmsnorm_bwd": 0,
              "flash_attention_bwd": 0}

    def counted(name, fn):
        def kernel(*args, **kw):
            counts[name] += 1
            with torch.no_grad():
                return fn(*args, **kw)
        return kernel

    def flash(q, k, v, *, causal, window, return_lse=False):
        o = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        if not return_lse:
            return o
        return o, ref.flash_attention_lse_ref(q, k, v, causal=causal,
                                              window=window)

    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(ops, "rmsnorm_cuda", counted(
        "rmsnorm", lambda x, s, *, eps: ref.rmsnorm_ref(x, s, eps)))
    monkeypatch.setattr(ops, "flash_attention_cuda",
                        counted("flash_attention", flash))
    monkeypatch.setattr(ops, "rmsnorm_bwd_cuda", counted(
        "rmsnorm_bwd", lambda x, s, g, *, eps: ref.rmsnorm_bwd_ref(
            x, s, g, eps)))
    monkeypatch.setattr(ops, "flash_attention_bwd_cuda", counted(
        "flash_attention_bwd", ref.flash_attention_bwd_ref))
    _, _, cfg, flat = _twins("qwen3-0.6b")
    n = cfg.n_layers
    for remat, fwd in ((True, 2), (False, 1)):
        for k in counts:
            counts[k] = 0
        state = S.init_train_state(lm_params_from_numpy(flat, cfg,
                                                        device="cpu"))
        step = S.build_train_step(cfg, TrainConfig(remat=remat, **STEP_KW))
        _, loss = step(state, {"tokens": torch.from_numpy(
            _tokens(5, cfg.vocab_size))})
        assert bool(torch.isfinite(loss))
        assert counts == {"rmsnorm": fwd * 4 * n + 1,
                          "flash_attention": fwd * n,
                          "rmsnorm_bwd": 4 * n + 1,
                          "flash_attention_bwd": n}, (remat, counts)


# ------------------------------------------------------------ train steps

_TRAJECTORIES = {}


def _trajectory(arch):
    """Three train steps of each package from the same weights on the
    same batches: after each, the reference's and the port's (loss, step,
    params, mu, nu) as path-keyed numpy."""
    if arch in _TRAJECTORIES:
        return _TRAJECTORIES[arch]
    jcfg, jp, cfg, flat = _twins(arch)
    mesh = make_host_mesh()
    jstep = JS.build_train_step(jcfg, JTrainConfig(**TRAJ_KW), mesh,
                                ShapeConfig("test", L, B, "train"))[0]
    jstate = JS.TrainState(params=jp, opt=jadamw_init(jp),
                           step=jnp.zeros((), jnp.int32))
    state = S.init_train_state(lm_params_from_numpy(flat, cfg, device="cpu"))
    step = S.build_train_step(cfg, TrainConfig(**TRAJ_KW))
    out = []
    for i in range(3):
        toks = _tokens(10 + i, cfg.vocab_size)
        with mesh:
            jstate, jloss = jstep(jstate, {"tokens": jnp.asarray(toks)})
        state, loss = step(state, {"tokens": torch.from_numpy(toks)})

        def ref_side(t):
            return _flatten_with_paths(t)[0]

        def port_side(tree):
            # copies: the port updates its tensors in place, and on the CPU
            # .numpy() shares their memory
            return {k: v.copy() for k, v in
                    lm_params_to_numpy(tree, cfg).items()}

        out.append({
            "ref": (float(jloss), int(jstate.step), ref_side(jstate.params),
                    ref_side(jstate.opt.mu), ref_side(jstate.opt.nu),
                    int(jstate.opt.count)),
            "port": (float(loss), state.step, port_side(state.params),
                     port_side(_tree_like(state.params, state.opt.mu)),
                     port_side(_tree_like(state.params, state.opt.nu)),
                     state.opt.count)})
    _TRAJECTORIES[arch] = out
    return out


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch, n_steps):
    after = _trajectory(arch)[n_steps - 1]
    (jloss, jstep, jparams, jmu, jnu, jcount) = after["ref"]
    (loss, step, params, mu, nu, count) = after["port"]
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    assert step == jstep == count == jcount == n_steps
    assert sorted(params) == sorted(jparams)
    initial = _twins(arch)[3]
    for key, want in jparams.items():
        if n_steps == 1:             # the warmup's learning rate is 0
            np.testing.assert_array_equal(np.asarray(want), initial[key])
            np.testing.assert_array_equal(params[key], initial[key])
            continue
        moved = float(np.abs(np.asarray(want) - initial[key]).max())
        assert moved >= 0.5 * TRAJ_KW["learning_rate"], (key, moved)
        np.testing.assert_allclose(params[key], np.asarray(want), rtol=0,
                                   atol=PARAM_ATOL, err_msg=key)
    _close_per_leaf(mu, jmu, MOMENT_RTOL, "mu")
    _close_per_leaf(nu, jnu, MOMENT_RTOL, "nu")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_applies_the_reference_adamw(arch):
    """One port step past warmup (its learning rate the base rate), weight
    decay 0.5, the default clip: the reference's ``adamw_update`` at the
    reference's ``warmup_cosine`` rate, applied to the port's own
    ``lm_loss`` gradient from the same weights, gives the port's
    parameters within ADAMW_ATOL and its moments within MOMENT_RTOL of
    each leaf's largest element."""
    _, _, cfg, flat = _twins(arch)
    tcfg = TrainConfig(**dict(TRAJ_KW, warmup_steps=0, remat=False))
    toks = torch.from_numpy(_tokens(20, cfg.vocab_size))
    state = S.init_train_state(lm_params_from_numpy(
        {k: v.copy() for k, v in flat.items()}, cfg, device="cpu"))
    params = state.params
    loss = T.lm_loss(params, cfg, toks, remat=False)
    grads = torch.autograd.grad(loss, leaves(params), allow_unused=True,
                                materialize_grads=True)
    g = {k: v.copy() for k, v in
         lm_params_to_numpy(_tree_like(params, grads), cfg).items()}
    lr = jsched.warmup_cosine(0, base_lr=tcfg.learning_rate,
                              warmup_steps=0, total_steps=tcfg.total_steps)
    assert float(lr) == np.float32(tcfg.learning_rate)
    p0 = {k: jnp.asarray(v) for k, v in flat.items()}
    want, jopt = jadamw_update(p0, {k: jnp.asarray(v) for k, v in g.items()},
                               jadamw_init(p0), lr=lr, b1=tcfg.b1,
                               b2=tcfg.b2, weight_decay=tcfg.weight_decay,
                               grad_clip=tcfg.grad_clip)
    state, step_loss = S.build_train_step(cfg, tcfg)(state,
                                                     {"tokens": toks})
    assert float(step_loss) == float(loss.detach())
    got = lm_params_to_numpy(state.params, cfg)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], np.asarray(w), rtol=0,
                                   atol=ADAMW_ATOL, err_msg=key)
    _close_per_leaf(lm_params_to_numpy(_tree_like(state.params, state.opt.mu),
                                       cfg), jopt.mu, MOMENT_RTOL, "mu")
    _close_per_leaf(lm_params_to_numpy(_tree_like(state.params, state.opt.nu),
                                       cfg), jopt.nu, MOMENT_RTOL, "nu")


# ------------------------------------------------------ the entry points

def _losses(text):
    return [float(line.split("loss")[1].split()[0])
            for line in text.splitlines() if line.startswith("step")]


def test_train_cli_on_cpu_loss_falls(capsys):
    """The reference's test_train_loss_decreases rule, on the port's
    launcher: 30 SMOKE steps, the last logged loss below the first."""
    state, losses = train.main(["--smoke", "--device", "cpu", "--steps",
                                "30", "--batch", "4", "--seq", "64",
                                "--log-every", "29"])
    logged = _losses(capsys.readouterr().out)
    assert len(logged) == 2 and logged[-1] < logged[0], logged
    assert len(losses) == 30 and all(np.isfinite(losses))
    assert state.step == 30 and state.opt.count == 30


def test_train_cli_saves_and_restores(tmp_path, capsys):
    """--ckpt-dir: every --ckpt-every steps a versioned checkpoint; a
    second run restores the latest and goes on from its step."""
    ck = str(tmp_path / "ck")
    args = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "16",
            "--ckpt-dir", ck, "--ckpt-every", "2", "--log-every", "1"]
    first, _ = train.main(args + ["--steps", "4"])
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_00000002.npz", "step_00000002.npz.json",
        "step_00000004.npz", "step_00000004.npz.json"]
    saved = npz.to_arrays(first)
    like = train.init_state(smoke_config("qwen3-0.6b"), 1, "cpu")
    restored, at = npz.restore(ck, like)
    assert at == 4
    for key, arr in npz.to_arrays(restored).items():
        np.testing.assert_array_equal(arr, saved[key], err_msg=key)
    capsys.readouterr()
    second, losses = train.main(args + ["--steps", "5"])
    out = capsys.readouterr().out
    assert "restored checkpoint at step 4" in out
    assert _losses(out) and out.count("\nstep ") == 1 and len(losses) == 1
    assert second.step == 5 and second.opt.count == 5


def test_lm_on_codes_small_on_cpu(capsys):
    out = train_lm_on_codes.run(steps=3, batch=4, small=True, device="cpu")
    codes = out["codes"]
    assert tuple(codes.shape) == (256, 64) and codes.dtype == torch.int32
    assert int(codes.min()) >= 0 and int(codes.max()) < 256
    assert out["uplink_bytes"] == 256 * 64          # 8-bit codes
    assert out["cfg"].vocab_size == 256
    assert len(out["losses"]) == 3
    assert all(bool(torch.isfinite(x)) for x in out["losses"])
    assert "LM-on-codes training done." in capsys.readouterr().out


def test_entry_points_raise_without_device_cpu_here():
    """With no card, the entry points raise unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_lm_on_codes.main(["--small", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.init_state(smoke_config("qwen3-0.6b"), 0, None)
