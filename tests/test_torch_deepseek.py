"""Port parity: deepseek-v3's Multi-Token Prediction (MTP) branch of
``lm_loss``, the train step with it, and the flash kernel's padding route
for head dims it is not built for, against the JAX package.

Configs: deepseek-v3's ``SMOKE`` (MLA, sigmoid top-2-of-4 routing with a
shared expert, MTP) and the qwen3 and minicpm3 ``SMOKE`` configs with
``use_mtp`` set (attention with qk-norm; MLA). Weights are the reference's
own ``init_lm`` arrays, carried into the port by ``repro_torch.convert``;
tokens come from numpy.

Tolerances are ``test_torch_lm_train.py``'s: losses 1e-5 relative, each
gradient within 1e-4 of its leaf's largest element, parameters after
AdamW steps 1e-4 absolute and moments 1e-5 of each leaf's largest element.
The MTP branch's hidden states against the reference's 2e-5 absolute and
relative. The padding route: the plain version on zero-padded heads
within 1e-6 of the attention in float64, as the unpadded float32 plain
path is, and so within 2e-6 of that path: the two place q's scale apart
(the padded q is multiplied by sqrt(D' / D) before the kernel's 1/sqrt(D')
and rounded there), and at N(0, 1) inputs over 45 keys each lands up to
~9e-7 off float64, the two up to ~1.4e-6 apart.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.npz import _flatten_with_paths  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro.nn.layers import apply_norm as japply_norm  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs import TrainConfig  # noqa: E402
from repro_torch.convert import (_flatten, lm_params_from_numpy,  # noqa: E402,E501
                                 lm_params_to_numpy)
from repro_torch.distributed import steps as S  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import HEAD_DIMS  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.nn import attention as attn  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402
from test_torch_lm_train import (GRAD_RTOL, LOSS_RTOL,  # noqa: E402
                                 MOMENT_RTOL, PARAM_ATOL, TRAJ_KW,
                                 _close_per_leaf, _tree_like)

CASES = ("deepseek_v3_671b", "qwen3_0_6b+mtp", "minicpm3_4b+mtp")
B, L = 2, 24
TOL = 2e-5
PAD_TOL = 1e-6                   # of the attention in float64
PLAIN_TOL = 2 * PAD_TOL          # of the unpadded float32 plain path


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU tensors run far faster on one thread than on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(case):
    """(reference config, port config) of ``case``: an arch's SMOKE
    config, with MTP where the case says ``+mtp``."""
    arch, _, mtp = case.partition("+")
    jcfg, cfg = jsmoke_config(arch), smoke_config(arch)
    if mtp:
        jcfg, cfg = jcfg.replace(use_mtp=True), cfg.replace(use_mtp=True)
    assert jcfg.use_mtp and cfg.use_mtp
    return jcfg, cfg


_TWINS = {}


def _twins(case):
    """The reference's config and weights, the port's config and the flat
    arrays."""
    if case not in _TWINS:
        jcfg, cfg = _cfgs(case)
        jp = JT.init_lm(jax.random.PRNGKey(0), jcfg)
        _TWINS[case] = (jcfg, jp, cfg, _flatten_with_paths(jp)[0])
    return _TWINS[case]


def _tokens(seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, L)) \
        .astype(np.int32)


# ----------------------------------------------------------- the MTP head

@pytest.mark.parametrize("case", CASES)
def test_init_lm_draws_the_mtp_head(case):
    """``init_lm`` draws ``mtp`` in the reference's leaf shapes: ``proj``
    (2d, d) at N(0, 1) * 0.02 as the embedding, one attention/dense
    block, its norm at ones."""
    jcfg, cfg = _cfgs(case)
    tree = jax.eval_shape(lambda: JT.init_lm(jax.random.PRNGKey(0), jcfg))
    flat, _ = jax.tree_util.tree_flatten_with_path(tree["mtp"])
    want = {"/".join(str(p.key) for p in path): tuple(leaf.shape)
            for path, leaf in flat}
    params = T.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    got = {k: tuple(v.shape) for k, v in _flatten(params["mtp"]).items()}
    assert got == want
    proj = params["mtp"]["proj"]
    assert abs(float(proj.std()) - 0.02) < 2e-3
    assert bool((params["mtp"]["norm"]["scale"] == 1).all())


@pytest.mark.parametrize("case", CASES)
def test_mtp_hidden_matches_reference_branch(case):
    """``mtp_hidden`` (proj, the block at positions 0 ... T - 3 with its
    own RoPE angles, the norm) against the reference's ``lm_loss`` branch
    written out from its parts, on the same final hidden states."""
    jcfg, jp, cfg, flat = _twins(case)
    params = lm_params_from_numpy(flat, cfg, device="cpu")
    toks = _tokens(7, cfg.vocab_size)
    hidden = np.array(JT.forward(jp, jcfg, jnp.asarray(toks)).hidden)
    h = jnp.asarray(hidden)[:, :-2]
    nxt = jp["embed"][jnp.asarray(toks)[:, 1:-1]]
    z = jnp.concatenate([h, nxt], axis=-1) @ jp["mtp"]["proj"]
    pos = jnp.broadcast_to(jnp.arange(z.shape[1])[None], z.shape[:2])
    z = JT._apply_block(jp["mtp"]["block"], jcfg, "attn", "dense", z,
                        pos)[0]
    want = japply_norm(jcfg.norm, jp["mtp"]["norm"], z, jcfg.norm_eps)
    got = T.mtp_hidden(params, cfg, torch.from_numpy(hidden),
                       torch.from_numpy(toks))
    assert got.shape == (B, L - 2, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def _port_loss_grads(case, toks, remat):
    _, _, cfg, flat = _twins(case)
    params = lm_params_from_numpy(flat, cfg, device="cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    loss = T.lm_loss(params, cfg, torch.from_numpy(toks), remat=remat)
    grads = torch.autograd.grad(loss, leaves(params), allow_unused=True,
                                materialize_grads=True)
    return float(loss.detach()), lm_params_to_numpy(
        _tree_like(params, grads), cfg)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_lm_loss_with_mtp_and_gradients_match_reference(case, remat):
    """The loss (next-token cross-entropy, MoE aux, 0.3 x the MTP
    cross-entropy against tokens 2 ... T - 1) and every leaf's gradient,
    the ``mtp`` leaves included, against ``jax.value_and_grad`` of the
    reference's ``lm_loss``."""
    jcfg, jp, cfg, _ = _twins(case)
    toks = _tokens(3, cfg.vocab_size)
    want, jgrads = jax.value_and_grad(lambda p: JT.lm_loss(
        p, jcfg, jnp.asarray(toks), remat=remat))(jp)
    got, grads = _port_loss_grads(case, toks, remat)
    np.testing.assert_allclose(got, float(want), rtol=LOSS_RTOL)
    jflat = _flatten_with_paths(jgrads)[0]
    assert any(k.startswith("mtp/") for k in jflat)
    _close_per_leaf(grads, jflat, GRAD_RTOL, "gradient")


@pytest.mark.parametrize("case", CASES)
def test_mtp_term_is_weighted_into_the_loss(case):
    """With MTP the loss is the loss without it plus ``mtp_loss_weight``
    (0.3) times the branch's own cross-entropy."""
    _, _, cfg, flat = _twins(case)
    params = lm_params_from_numpy(flat, cfg, device="cpu")
    toks = torch.from_numpy(_tokens(5, cfg.vocab_size))
    with torch.no_grad():
        both = T.lm_loss(params, cfg, toks, remat=False)
        main = T.lm_loss(params, cfg.replace(use_mtp=False), toks,
                         remat=False)
        hidden = T.hidden_states(params, cfg, toks)
        logits = T._lm_head(params, cfg, T.mtp_hidden(params, cfg, hidden,
                                                      toks))
        nll2 = torch.nn.functional.cross_entropy(
            logits.reshape(-1, cfg.vocab_size), toks[:, 2:].reshape(-1)
            .long())
    assert cfg.mtp_loss_weight == 0.3
    np.testing.assert_allclose(float(both), float(main + 0.3 * nll2),
                               rtol=1e-6)


def _counted_card(monkeypatch, counts, widths):
    """``ops`` as on the card, its kernel symbols counted plain versions;
    the flash forward records each call's head dim."""
    def counted(name, fn):
        def kernel(*args, **kw):
            counts[name] += 1
            with torch.no_grad():
                return fn(*args, **kw)
        return kernel

    def flash(q, k, v, *, causal, window, return_lse=False):
        widths.append(q.shape[-1])
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


@pytest.mark.parametrize("grad", [False, True])
def test_mtp_loss_launch_counts_on_a_patched_card(grad, monkeypatch):
    """On the card (patched with counted plain versions) deepseek SMOKE's
    ``lm_loss`` (remat off) runs the flash forward once a layer and once
    in the MTP block, every one at 64 (the MLA layers' q/k 48 and the MTP
    block's 64); rmsnorm 4 a layer (pre, post, q_norm, kv_norm), the final
    norm, 2 in the MTP block and its norm. With a graph, each backward
    kernel once for its forward."""
    counts = dict.fromkeys(("rmsnorm", "flash_attention", "rmsnorm_bwd",
                            "flash_attention_bwd"), 0)
    widths = []
    _counted_card(monkeypatch, counts, widths)
    _, _, cfg, flat = _twins("deepseek_v3_671b")
    params = lm_params_from_numpy(flat, cfg, device="cpu")
    toks = torch.from_numpy(_tokens(6, cfg.vocab_size))
    n = cfg.n_layers
    if grad:
        for p in leaves(params):
            p.requires_grad_(True)
        loss = T.lm_loss(params, cfg, toks, remat=False)
        torch.autograd.grad(loss, leaves(params), allow_unused=True)
    else:
        with torch.no_grad():
            loss = T.lm_loss(params, cfg, toks, remat=False)
    assert bool(torch.isfinite(loss))
    norms = 4 * n + 1 + 2 + 1
    assert counts == {"rmsnorm": norms, "flash_attention": n + 1,
                      "rmsnorm_bwd": norms * grad,
                      "flash_attention_bwd": (n + 1) * grad}, counts
    assert widths == [64] * (n + 1)


# ------------------------------------------------------------ train steps

_TRAJECTORIES = {}


def _trajectory(case):
    """Three train steps of each package from the same weights on the
    same batches (the reference's ``build_train_step(...)[0]`` eagerly
    under a host mesh): after each, (loss, step, params, mu, nu, count)
    of both as path-keyed numpy."""
    from repro.configs.base import ShapeConfig
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.distributed import steps as JS
    from repro.launch.mesh import make_host_mesh
    from repro.optim.adamw import adamw_init as jadamw_init
    if case in _TRAJECTORIES:
        return _TRAJECTORIES[case]
    jcfg, jp, cfg, flat = _twins(case)
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

        def port_side(tree):
            # copies: the port updates in place, .numpy() shares memory
            return {k: v.copy() for k, v in
                    lm_params_to_numpy(tree, cfg).items()}

        out.append({
            "ref": (float(jloss), int(jstate.step),
                    _flatten_with_paths(jstate.params)[0],
                    _flatten_with_paths(jstate.opt.mu)[0],
                    _flatten_with_paths(jstate.opt.nu)[0],
                    int(jstate.opt.count)),
            "port": (float(loss), state.step, port_side(state.params),
                     port_side(_tree_like(state.params, state.opt.mu)),
                     port_side(_tree_like(state.params, state.opt.nu)),
                     state.opt.count)})
    _TRAJECTORIES[case] = out
    return out


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("case", CASES)
def test_train_steps_with_mtp_match_reference(case, n_steps):
    """1 and 3 steps (warmup 1, so the first leaves the weights as they
    were; weight decay 0.5): loss, step counts, parameters (the ``mtp``
    leaves among them) and AdamW moments against the reference's."""
    after = _trajectory(case)[n_steps - 1]
    (jloss, jstep, jparams, jmu, jnu, jcount) = after["ref"]
    (loss, step, params, mu, nu, count) = after["port"]
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    assert step == jstep == count == jcount == n_steps
    assert sorted(params) == sorted(jparams)
    assert "mtp/proj" in params
    initial = _twins(case)[3]
    for key, want in jparams.items():
        if n_steps == 1:
            np.testing.assert_array_equal(params[key], initial[key])
            continue
        np.testing.assert_allclose(params[key], np.asarray(want), rtol=0,
                                   atol=PARAM_ATOL, err_msg=key)
    _close_per_leaf(mu, jmu, MOMENT_RTOL, "mu")
    _close_per_leaf(nu, jnu, MOMENT_RTOL, "nu")


def test_train_cli_smoke_on_cpu(capsys):
    """The port's launcher trains deepseek's SMOKE config (its loss has
    the MTP term): finite losses, the step count."""
    state, losses = train.main(["--arch", "deepseek-v3-671b", "--smoke",
                                "--device", "cpu", "--steps", "3",
                                "--batch", "2", "--seq", "16",
                                "--log-every", "1"])
    assert "arch=deepseek-smoke" in capsys.readouterr().out
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert state.step == 3 and "mtp" in state.params


# ------------------------------------------------------- the padding route

def _qkv(seed, Tq, Tk, hq, hkv, d):
    r = np.random.default_rng(seed)
    return (torch.from_numpy(r.standard_normal((B, Tq, hq, d))
                             .astype(np.float32)),
            torch.from_numpy(r.standard_normal((B, Tk, hkv, d))
                             .astype(np.float32)),
            torch.from_numpy(r.standard_normal((B, Tk, hkv, d))
                             .astype(np.float32)))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [40, 56, 80])
def test_padded_flash_equals_unpadded_plain(d, causal):
    """``attend``'s padding route (q, k and v zero-padded to the kernel's
    next head dim, q scaled, the output sliced) through the plain version:
    within 1e-6 of the attention at the true width in float64, as the
    unpadded plain paths are (the port's and the reference's), and within
    2e-6 of those."""
    Tq, Tk = (37, 37) if causal else (29, 45)
    q, k, v = _qkv(d, Tq, Tk, 4, 2, d)
    got = attn.attend(q, k, v, causal=causal)
    assert got.shape == (B, Tq, 4, d)
    plain = attn._attend_full(q, k, v, causal=causal)
    kr, vr = (t.repeat_interleave(2, 2) for t in (k, v))
    jplain = jattn._attend_full(*(jnp.asarray(t.numpy()) for t in (q, kr, vr)),
                                causal=causal, q_offset=0, window=0)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.double(), kr.double()) \
        / np.sqrt(d)
    if causal:
        scores = scores.masked_fill(~torch.ones(Tq, Tk, dtype=torch.bool)
                                    .tril(), -1e30)
    exact = torch.einsum("bhqk,bkhd->bqhd", scores.softmax(-1),
                         vr.double()).numpy()
    for path in (got.numpy(), plain.numpy(), np.asarray(jplain)):
        np.testing.assert_allclose(path, exact, atol=PAD_TOL, rtol=0)
    for want in (plain.numpy(), np.asarray(jplain)):
        np.testing.assert_allclose(got.numpy(), want, atol=PLAIN_TOL,
                                   rtol=0)


@pytest.mark.parametrize("d,width", [(40, 64), (56, 64), (80, 96),
                                     (192, 192)])
def test_attend_reaches_the_flash_entry_at_a_kernel_width(d, width,
                                                          monkeypatch):
    """``attend`` at a head dim the kernel is not built for calls
    ``ops.flash_attention`` once, with q, k and v at the narrowest of
    ``HEAD_DIMS`` holding it (56, the MTP block's at deepseek-v3's full
    width, at 64), and never the plain ``_attend_full``; at one of them
    (192) it passes the heads as they are."""
    calls = []
    real = ops.flash_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape[-1], k.shape[-1], v.shape[-1]))
        return real(q, k, v, **kw)

    def refuse(*a, **kw):
        raise AssertionError("attend fell back to _attend_full")

    monkeypatch.setattr(ops, "flash_attention", spy)
    monkeypatch.setattr(attn, "_attend_full", refuse)
    q, k, v = _qkv(1, 20, 20, 2, 2, d)
    out = attn.attend(q, k, v, causal=True)
    assert out.shape == (B, 20, 2, d)
    assert calls == [(width,) * 3] and width in HEAD_DIMS
    assert attn.flash_width(d, d) == width


def test_full_mtp_block_runs_padded_and_wide_heads_raise():
    """deepseek-v3's MTP block attends at ``resolved_head_dim`` 7,168 /
    128 = 56, which no instance takes (BK * D / 4 = 448 is no multiple of
    the block's 128 threads): it runs at 64. Past 256 ``attend`` raises."""
    cfg = get_config("deepseek_v3_671b")
    assert cfg.resolved_head_dim == 56 and 56 not in HEAD_DIMS
    assert attn.flash_width(56, 56) == 64
    assert attn.flash_width(cfg.mla.qk_head_dim, cfg.mla.v_head_dim) == 192
    with pytest.raises(NotImplementedError, match="head dims"):
        attn.attend(*_qkv(2, 8, 8, 1, 1, 300))
