"""Port parity: the hybrid LM serving slice (jamba: Mamba, MoE and
attention blocks) against ``repro.models.transformer`` on shared weights
and tokens.

Weights are the reference's own ``init_lm`` arrays, carried into the port
through ``repro_torch.convert``; tokens come from numpy. Sizes are the
jamba ``SMOKE`` config (2 layers: Mamba + MoE, attention + MLP; capacity
factor 4.0, so prefill is dropless) and a narrow copy of one full period
of ``CONFIG`` (8 layers with attention at layer 4 and MoE on the odd
layers, 16 experts top-2 at capacity factor 1.25, so prefill drops
assignments and decode does not).

Tolerances: logits 2e-5 absolute and relative, hidden states and caches
5e-5 (float32 sums in another order, through exp and softplus in each
Mamba layer; logits here are below 2 in magnitude). Greedy tokens are
identical except at near ties: a token may differ only where the
reference's top two logits are within 1e-3*(1 + |top|).
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
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.convert import (init_numpy_lm_params,  # noqa: E402
                                 lm_params_from_numpy, lm_params_to_numpy)
from repro_torch.distributed import steps as S  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCH = "jamba_v0_1_52b"
TOL = 2e-5
STATE_TOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU tensors run far faster on one thread than on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _period(cfg):
    """One full 8-layer period of ``CONFIG`` at a narrow width."""
    return cfg.replace(n_layers=8, d_model=64, n_heads=2, n_kv_heads=1,
                       d_ff=128, vocab_size=256,
                       moe=dataclasses.replace(cfg.moe, d_ff_expert=64))


# the reference's decode step, compiled once per config (eager, one step
# of the 8-layer period takes seconds)
_jdecode = jax.jit(JT.decode_step, static_argnums=1)


SIZES = {"smoke": lambda get: get[1](ARCH),
         "period": lambda get: _period(get[0](ARCH))}


def _build(size, seed=0):
    jcfg = SIZES[size]((jget_config, jsmoke_config))
    cfg = SIZES[size]((get_config, smoke_config))
    jp = JT.init_lm(jax.random.PRNGKey(seed), jcfg)
    flat, _ = _flatten_with_paths(jp)
    return jcfg, jp, cfg, lm_params_from_numpy(flat, cfg, device="cpu"), flat


@pytest.fixture(scope="module", params=list(SIZES))
def twins(request):
    return _build(request.param)


def _tokens(seed, B, T_, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, T_)) \
        .astype(np.int32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol, err_msg=what)


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
    assert get_config("jamba-v0.1-52b") == get_config(ARCH)


def test_one_period_keeps_every_kind_and_width():
    """The chip's cut: depth 32 -> 8 keeps attention at layer 4, MoE on the
    odd layers, and the published widths."""
    full = get_config(ARCH)
    cfg = full.replace(n_layers=8)
    assert cfg.layer_kinds() == (
        ("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"),
        ("mamba", "moe"), ("attn", "dense"), ("mamba", "moe"),
        ("mamba", "dense"), ("mamba", "moe"))
    assert full.layer_kinds()[:8] == cfg.layer_kinds()
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
            cfg.vocab_size, cfg.moe.n_experts, cfg.moe.d_ff_expert,
            cfg.ssm.d_state) == (4096, 32, 8, 14336, 65536, 16, 14336, 16)
    assert full.param_count() == jget_config(ARCH).param_count()
    assert 51.5e9 < full.param_count() < 51.6e9
    assert 13.2e9 < cfg.param_count() < 13.4e9
    T.check_supported(cfg)


# -------------------------------------------------------------- converter

def test_params_round_trip(twins):
    _, _, cfg, params, flat = twins
    back = lm_params_to_numpy(params, cfg)
    assert set(back) == set(flat)
    for key, arr in flat.items():
        np.testing.assert_array_equal(back[key], arr, err_msg=key)
    assert len(params["segments"]) == len(T.segment_plan(cfg))


def test_numpy_init_has_reference_layout(twins):
    _, _, cfg, _, flat = twins
    mine = init_numpy_lm_params(cfg, seed=3)
    assert {k: v.shape for k, v in mine.items()} == \
        {k: v.shape for k, v in flat.items()}
    assert all(v.dtype == np.float32 for v in mine.values())
    for key, arr in mine.items():
        if key.endswith("mixer/A_log"):
            np.testing.assert_allclose(arr, flat[key], rtol=1e-7)
        if key.endswith("mixer/D"):
            assert (arr == 1).all()
        if key.endswith("mixer/dt_bias"):
            dt = np.log1p(np.exp(arr))
            assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 0.1 * 1.00001
        if "ffn/experts/" in key:             # fan-in is the second axis
            bound = 1 / np.sqrt(arr.shape[2])
            assert np.abs(arr).max() <= bound
            assert np.abs(arr).max() > 0.9 * bound


def test_port_init_lm_matches_layout(twins):
    _, _, cfg, params, _ = twins
    mine = T.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert {k: v.shape for k, v in lm_params_to_numpy(mine, cfg).items()} \
        == {k: v.shape for k, v in lm_params_to_numpy(params, cfg).items()}


# ---------------------------------------------------------- prefill/decode

def test_prefill_matches_reference(twins):
    jcfg, jp, cfg, params, _ = twins
    toks = _tokens(0, 2, 24, cfg.vocab_size)
    want = JT.prefill(jp, jcfg, jnp.asarray(toks))
    out = T.prefill(params, cfg, torch.from_numpy(toks))
    _close(out.logits.numpy(), want.logits, TOL, "logits")
    _close(out.hidden.numpy(), want.hidden, STATE_TOL, "hidden")
    _close(float(out.aux_loss), float(want.aux_loss), TOL, "aux_loss")
    last = S.prefill_step(params, cfg, torch.from_numpy(toks))
    assert tuple(last.shape) == (2, cfg.vocab_size)
    _close(last.numpy(), np.asarray(want.logits)[:, -1], TOL, "last")


def test_decode_matches_reference(twins):
    """Each decode step's logits against the reference's decode_step, then
    every cache (Mamba state and window, attention KV) after the last."""
    jcfg, jp, cfg, params, _ = twins
    S_ = 8
    toks = _tokens(3, 2, S_, cfg.vocab_size)
    caches = T.init_caches(cfg, 2, S_ + 2, device="cpu")
    jcaches = JT.init_caches(jcfg, 2, S_ + 2)
    for t in range(S_):
        lg, caches = T.decode_step(params, cfg, torch.from_numpy(
            toks[:, t:t + 1]), caches, t)
        jlg, jcaches = _jdecode(jp, jcfg, jnp.asarray(toks[:, t:t + 1]),
                               jcaches, jnp.int32(t))
        _close(lg.numpy(), jlg, TOL, f"logits {t}")
    for si, (mine, theirs) in enumerate(zip(caches, jcaches)):
        assert type(mine).__name__ == type(theirs).__name__
        for name, a, b in zip(mine._fields, mine, theirs):
            _close(a.numpy(), b, STATE_TOL, f"segment {si} {name}")


def test_smoke_decode_replays_prefill():
    """At the SMOKE config prefill is dropless (capacity factor 4.0 with 4
    experts), so decode and prefill compute one function."""
    _, _, cfg, params, _ = _build("smoke", seed=2)
    toks = _tokens(4, 2, 10, cfg.vocab_size)
    full = T.prefill(params, cfg, torch.from_numpy(toks)).logits.numpy()
    caches = T.init_caches(cfg, 2, 10, device="cpu")
    for t in range(10):
        lg, caches = T.decode_step(params, cfg, torch.from_numpy(
            toks[:, t:t + 1]), caches, t)
        _close(lg.numpy()[:, 0], full[:, t], TOL, f"position {t}")


def test_greedy_serve_loop_matches_reference(twins):
    """The launcher's loop (prompt fed token by token, then argmax) against
    the same loop over the reference's decode_step."""
    jcfg, jp, cfg, params, _ = twins
    P, gen = 5, 6
    prompts = _tokens(5, 2, P, cfg.vocab_size)
    got = serve.generate(params, cfg, torch.from_numpy(prompts), gen).numpy()
    assert got.shape == (2, P + gen)
    np.testing.assert_array_equal(got[:, :P], prompts)
    jcaches = JT.init_caches(jcfg, 2, P + gen)
    tok = jnp.asarray(prompts[:, :1])
    for t in range(P + gen - 1):
        lg, jcaches = _jdecode(jp, jcfg, tok, jcaches, jnp.int32(t))
        if t + 1 < P:
            tok = jnp.asarray(prompts[:, t + 1:t + 2])
            continue
        nxt = np.asarray(jnp.argmax(lg[:, -1], axis=-1))
        ties = ref.near_ties(-torch.from_numpy(np.array(lg[:, -1]))).numpy()
        assert not ((got[:, t + 1] != nxt) & ~ties).any(), f"step {t}"
        tok = jnp.asarray(got[:, t + 1:t + 2])       # follow the port's path


def test_launcher_cli_on_cpu(capsys):
    seqs = serve.main(["--arch", "jamba-v0.1-52b", "--smoke", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "5",
                       "--gen", "4"])
    out = capsys.readouterr().out
    assert "arch=jamba-smoke generated 2x4 tokens" in out
    assert tuple(seqs.shape) == (2, 9)
    assert int(seqs.min()) >= 0 and int(seqs.max()) < 512
