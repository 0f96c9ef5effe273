"""Port parity: the xLSTM mixers (``repro_torch.nn.xlstm``) and the
xlstm-350m model against ``repro.nn.xlstm`` and ``repro.models.transformer``
on shared weights and inputs.

Weights are the reference's own ``init_mlstm`` / ``init_slstm`` /
``init_lm`` arrays, carried into the port as numpy (the model's through
``repro_torch.convert.lm_params_from_numpy``); inputs come from numpy.
Sizes: the xlstm ``SMOKE`` config (d 256, mLSTM di 512 in 4 heads of 128,
sLSTM 4 heads of 64, GeGLU 341 wide) and chunks of 128.

Tolerance: the same algorithm in float32 with sums in another order, so
every output, state and logit is held within ``RTOL`` = 1e-5 of its
largest magnitude (``close``). One case is looser: a whole 128-step
chunk on unit-normal random q, k, v, whose h divides by denominators near
0. There the reference's own float32 h is 1e-5-3e-5 of its largest off
the exact (float64) value, so the port is held instead to be no further
from the float64 evaluation than twice the reference is, with that
float64 evaluation within 1e-4 of the reference (``close_or_exact``). The
stabiliser ``m`` starts at -1e30 and padded steps carry an input gate of
-1e30, so every state is also held finite: no NaN, no inf.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.npz import _flatten_with_paths  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.nn import xlstm as JX  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.convert import (init_numpy_lm_params,  # noqa: E402
                                 lm_block_spec, lm_params_from_numpy,
                                 lm_params_to_numpy)
from repro_torch.distributed import steps as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.nn import xlstm as X  # noqa: E402

ARCH = "xlstm_350m"
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU tensors run far faster on one thread than on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, what="", rtol=RTOL):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), f"{what}: not finite"
    err = np.abs(got - want).max() if got.size else 0.0
    limit = rtol * max(np.abs(want).max(), 1e-30)
    assert err <= limit, f"{what}: {err} > {limit}"


def close_or_exact(got, want, exact, what=""):
    """``close``, or: the float64 ``exact`` within 1e-4 of ``want``'s
    largest magnitude and ``got`` no further from it than twice ``want``
    is."""
    got, exact = (np.asarray(t.detach(), np.float64) for t in (got, exact))
    want = np.asarray(want, np.float64)
    assert np.isfinite(got).all(), f"{what}: not finite"
    peak = max(np.abs(want).max(), 1e-30)
    if np.abs(got - want).max() <= RTOL * peak:
        return
    ref_off = np.abs(want - exact).max()
    assert ref_off <= 1e-4 * peak, f"{what}: float64 off by {ref_off}"
    port_off = np.abs(got - exact).max()
    assert port_off <= 2 * ref_off, f"{what}: {port_off} > 2 * {ref_off}"


def tree_to_torch(tree):
    if isinstance(tree, dict):
        return {k: tree_to_torch(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


def rng(seed):
    return np.random.default_rng(seed)


def normal(r, *shape, scale=1.0):
    return (r.standard_normal(shape) * scale).astype(np.float32)


CFG = smoke_config(ARCH)
JCFG = jsmoke_config(ARCH)
MIXERS = {"mlstm": (JX.init_mlstm, JX.mlstm, X.mlstm, JX.init_mlstm_cache,
                    X.init_mlstm_cache),
          "slstm": (JX.init_slstm, JX.slstm, X.slstm, JX.init_slstm_cache,
                    X.init_slstm_cache)}


@pytest.fixture(scope="module", params=list(MIXERS))
def mixer(request):
    init, jfn, fn, jcache, cache = MIXERS[request.param]
    jp = init(jax.random.PRNGKey(3), JCFG)
    return request.param, jp, tree_to_torch(jp), jfn, fn, jcache, cache


def run_both(mixer, x, **kw):
    _, jp, p, jfn, fn, _, _ = mixer
    want = jfn(jp, JCFG, jnp.asarray(x), **kw)
    got = fn(p, CFG, torch.from_numpy(x))
    return got, want


# ---------------------------------------------------------------- configs

@pytest.mark.parametrize("getter", ["get_config", "smoke_config"])
def test_config_equals_reference(getter):
    port = {"get_config": get_config, "smoke_config": smoke_config}[getter]
    jref = {"get_config": jget_config, "smoke_config": jsmoke_config}[getter]
    a, b = port(ARCH), jref(ARCH)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.param_count() == b.param_count()
    assert a.layer_kinds() == b.layer_kinds()
    assert T.segment_plan(a) == JT.segment_plan(b)
    assert get_config("xlstm-350m") == get_config(ARCH)


def test_full_config_layout():
    """Layer i is sLSTM when (i + 1) % 6 == 0; no block has a feed-forward;
    320 M parameters by the reference's count."""
    cfg = get_config(ARCH)
    kinds = cfg.layer_kinds()
    assert [i for i, (m, _) in enumerate(kinds) if m == "slstm"] == \
        [5, 11, 17, 23]
    assert {f for _, f in kinds} == {"none"}
    assert cfg.param_count() == 319_938_492
    assert (X.inner_dim(cfg), X.ffn_dim(cfg), X.NH) == (2048, 1364, 4)
    spec = lm_block_spec(cfg, "mlstm", "none")
    assert "post_norm/scale" not in spec and "ffn/wi" not in spec
    T.check_supported(cfg)


# ------------------------------------------------------------ mLSTM chunk

@pytest.mark.parametrize("L", [1, 7, 128])
@pytest.mark.parametrize("fresh", [True, False])
def test_mlstm_chunk_matches_reference(L, fresh):
    r = rng(L + fresh)
    B, H, DH = 2, X.NH, 16
    q, k, v = (normal(r, B, H, L, DH) for _ in range(3))
    ig = normal(r, B, H, L)
    lf = np.log(1 / (1 + np.exp(-normal(r, B, H, L, scale=2.0)))) \
        .astype(np.float32)
    if fresh:
        C = np.zeros((B, H, DH, DH), np.float32)
        n = np.zeros((B, H, DH), np.float32)
        m = np.full((B, H), -1e30, np.float32)
    else:
        C, n, m = (normal(r, B, H, DH, DH), normal(r, B, H, DH),
                   normal(r, B, H))
    args = (q, k, v, ig, lf, C, n, m)
    want = JX._mlstm_chunk(*map(jnp.asarray, args))
    got = X._mlstm_chunk(*map(torch.from_numpy, args))
    exact = X._mlstm_chunk(*(torch.from_numpy(a).double() for a in args))
    for name, a, b, c in zip(("h", "C", "n", "m"), got, want, exact):
        close_or_exact(a, b, c, name)


# ----------------------------------------------------------- mLSTM, sLSTM

@pytest.mark.parametrize("T_", [10, 128, 300, 1])
def test_mixer_prefill_matches_reference(mixer, T_):
    """T 300 pads the mLSTM's last chunk by 84 steps; T 1 takes the
    decode-shaped chunk of one step from a fresh state."""
    x = normal(rng(T_), 2, T_, CFG.d_model)
    (out, cache), (jout, jcache) = run_both(mixer, x)
    close(out, jout, f"{mixer[0]} out")
    for name, a, b in zip(cache._fields, cache, jcache):
        close(a, b, f"{mixer[0]} {name}")


@pytest.mark.parametrize("T_", [3, 20])
def test_mixer_decode_matches_reference_and_prefill(mixer, T_):
    """One decode step a position from an empty cache (left-padded conv
    window while T < K - 1): each step's output against the reference's
    step and against the port's own prefill, and the final caches."""
    name, jp, p, jfn, fn, jinit, init = mixer
    x = normal(rng(100 + T_), 2, T_, CFG.d_model)
    pre, pre_cache = fn(p, CFG, torch.from_numpy(x))
    cache = init(CFG, 2, device="cpu")
    jcache = jinit(JCFG, 2)
    outs = []
    for t in range(T_):
        o, cache = fn(p, CFG, torch.from_numpy(x[:, t:t + 1]), cache=cache)
        jo, jcache = jfn(jp, JCFG, jnp.asarray(x[:, t:t + 1]), cache=jcache)
        close(o, jo, f"{name} step {t}")
        outs.append(o)
    close(torch.cat(outs, 1), pre.numpy(), f"{name} decode vs prefill")
    for field, a, b, c in zip(cache._fields, cache, jcache, pre_cache):
        close(a, b, f"{name} cache {field}")
        close(a, c.numpy(), f"{name} cache {field} vs prefill")


def test_mlstm_decode_refuses_more_than_one_token():
    p = tree_to_torch(JX.init_mlstm(jax.random.PRNGKey(0), JCFG))
    with pytest.raises(ValueError, match="one token"):
        X.mlstm(p, CFG, torch.zeros(1, 2, CFG.d_model),
                cache=X.init_mlstm_cache(CFG, 1, device="cpu"))


def test_caches_start_empty():
    mc = X.init_mlstm_cache(CFG, 3, device="cpu")
    sc = X.init_slstm_cache(CFG, 3, device="cpu")
    for mine, theirs in ((mc, JX.init_mlstm_cache(JCFG, 3)),
                         (sc, JX.init_slstm_cache(JCFG, 3))):
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    caches = T.init_caches(CFG, 3, 16, device="cpu")
    for c, (mixer_kind, _, n) in zip(caches, T.segment_plan(CFG)):
        assert float(c.m.max()) == float(c.m.min()) == float(
            np.float32(-1e30))
        assert all(t.shape[0] == n for t in c)


# ------------------------------------------------------------------ model

def _build(seed=0):
    jp = JT.init_lm(jax.random.PRNGKey(seed), JCFG)
    flat, _ = _flatten_with_paths(jp)
    return jp, lm_params_from_numpy(flat, CFG, device="cpu"), flat


@pytest.fixture(scope="module")
def twins():
    return _build()


def _tokens(seed, B, T_):
    return rng(seed).integers(0, CFG.vocab_size, (B, T_)).astype(np.int32)


def test_params_round_trip(twins):
    _, params, flat = twins
    back = lm_params_to_numpy(params, CFG)
    assert set(back) == set(flat)
    for key, arr in flat.items():
        np.testing.assert_array_equal(back[key], arr, err_msg=key)


def test_numpy_and_port_init_have_reference_layout(twins):
    _, params, flat = twins
    mine = init_numpy_lm_params(CFG, seed=3)
    assert {k: v.shape for k, v in mine.items()} == \
        {k: v.shape for k, v in flat.items()}
    bound = 1 / np.sqrt(CFG.d_model // X.NH)
    for key, arr in mine.items():
        if key.endswith("mixer/r"):                  # fan-in is DH
            assert bound * 0.9 < np.abs(arr).max() <= bound
        if key.endswith("skip_scale"):
            assert (arr == 1).all()
    drawn = T.init_lm(torch.Generator().manual_seed(0), CFG, device="cpu")
    assert {k: v.shape for k, v in lm_params_to_numpy(drawn, CFG).items()} \
        == {k: v.shape for k, v in lm_params_to_numpy(params, CFG).items()}


@pytest.mark.parametrize("T_", [24, 300])
def test_prefill_matches_reference(twins, T_):
    jp, params, _ = twins
    toks = _tokens(T_, 2, T_)
    want = JT.prefill(jp, JCFG, jnp.asarray(toks))
    out = T.prefill(params, CFG, torch.from_numpy(toks))
    close(out.logits, want.logits, "logits")
    close(out.hidden, want.hidden, "hidden")
    last = S.prefill_step(params, CFG, torch.from_numpy(toks))
    close(last, np.asarray(want.logits)[:, -1], "last")


_jdecode = jax.jit(JT.decode_step, static_argnums=1)


def test_decode_matches_reference_and_prefill(twins):
    """Each decode step's logits against the reference's decode_step and
    the port's prefill, then every layer's cache after the last step."""
    jp, params, _ = twins
    S_ = 12
    toks = _tokens(7, 2, S_)
    caches = T.init_caches(CFG, 2, S_, device="cpu")
    jcaches = JT.init_caches(JCFG, 2, S_)
    steps = []
    for t in range(S_):
        lg, caches = T.decode_step(params, CFG, torch.from_numpy(
            toks[:, t:t + 1]), caches, t)
        jlg, jcaches = _jdecode(jp, JCFG, jnp.asarray(toks[:, t:t + 1]),
                               jcaches, jnp.int32(t))
        close(lg, jlg, f"logits {t}")
        steps.append(lg)
    pre = T.prefill(params, CFG, torch.from_numpy(toks)).logits
    close(torch.cat(steps, 1), pre.numpy(), "decode vs prefill")
    for si, (mine, theirs) in enumerate(zip(caches, jcaches)):
        assert type(mine).__name__ == type(theirs).__name__
        for name, a, b in zip(mine._fields, mine, theirs):
            close(a, b, f"segment {si} {name}")


def test_greedy_serve_loop_matches_reference(twins):
    from repro_torch.launch import serve
    jp, params, _ = twins
    prompts = _tokens(9, 2, 5)
    seqs = serve.generate(params, CFG, torch.from_numpy(prompts), 6)
    assert tuple(seqs.shape) == (2, 11)
    caches = JT.init_caches(JCFG, 2, 11)
    tok = jnp.asarray(prompts[:, :1])
    for t in range(10):
        lg, caches = _jdecode(jp, JCFG, tok, caches, jnp.int32(t))
        nxt = seqs[:, t + 1].numpy()
        if t + 1 >= 5:             # generated: the reference's argmax but
            top2 = np.sort(np.asarray(lg[:, -1]), -1)[:, -2:]   # near ties
            tie = top2[:, 1] - top2[:, 0] <= 1e-3 * (1 + np.abs(top2[:, 1]))
            ref_next = np.asarray(lg[:, -1].argmax(-1))
            assert ((nxt == ref_next) | tie).all(), t
        tok = jnp.asarray(nxt[:, None].astype(np.int32))


def test_launcher_cli_on_cpu(capsys):
    from repro_torch.launch import serve
    seqs = serve.main(["--arch", "xlstm-350m", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "4", "--gen", "3"])
    assert tuple(seqs.shape) == (2, 7)
    assert "arch=xlstm-smoke" in capsys.readouterr().out
