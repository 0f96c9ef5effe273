"""Port parity: the LM serving slice (configs, converter, attention,
prefill, decode, the greedy serve loop, token data) against the JAX
package on shared weights and tokens.

Weights are the reference's own ``init_lm`` arrays, carried into the port
through ``repro_torch.convert``; tokens come from numpy. Sizes are the
qwen3 ``SMOKE`` config (2 layers, d 256, 4/2 heads of 64, vocab 512) and a
narrow variant at the full 28-layer depth.

Tolerances: logits and attention outputs 2e-5 absolute (float32 sums in
another order; logits here are below 2 in magnitude). Greedy tokens are
identical except at near ties: a token may differ only where the
reference's top two logits are within 1e-3*(1 + |top|).
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.npz import _flatten_with_paths  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro.nn import layers as jlayers  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.convert import (init_numpy_lm_params,  # noqa: E402
                                 lm_params_from_numpy, lm_params_to_numpy)
from repro_torch.data.synthetic import make_tokens  # noqa: E402
from repro_torch.distributed import steps as S  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.nn import attention as attn  # noqa: E402
from repro_torch.nn import layers  # noqa: E402

ARCH = "qwen3-0.6b"
TOL = 2e-5
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU tensors run far faster on one thread than on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _narrow_deep():
    """28 layers as qwen3-0.6b, at a narrow width."""
    return dict(n_layers=28, d_model=128, n_heads=2, n_kv_heads=1,
                head_dim=64, d_ff=256, vocab_size=256)


@pytest.fixture(scope="module")
def twins():
    """The reference's SMOKE weights, and the same arrays in the port."""
    jcfg, cfg = jsmoke_config(ARCH), smoke_config(ARCH)
    jp = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    flat, _ = _flatten_with_paths(jp)
    return jcfg, jp, cfg, lm_params_from_numpy(flat, cfg, device="cpu"), flat


def _tokens(seed, B, T_, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, T_)) \
        .astype(np.int32)


def _assert_tokens(got, want, ref_logits):
    """Identical greedy tokens except at near ties of ``ref_logits``."""
    got, want = np.asarray(got), np.asarray(want)
    diff = got != want
    ties = ref.near_ties(-torch.from_numpy(np.array(ref_logits))).numpy()
    assert not (diff & ~ties).any(), "tokens differ outside near ties"


# ---------------------------------------------------------------- configs

@pytest.mark.parametrize("getter", ["get_config", "smoke_config"])
def test_config_equals_reference(getter):
    port = {"get_config": get_config, "smoke_config": smoke_config}[getter]
    jref = {"get_config": jget_config, "smoke_config": jsmoke_config}[getter]
    a, b = port(ARCH), jref(ARCH)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.param_count() == b.param_count()
    assert a.layer_kinds() == b.layer_kinds()
    assert (a.resolved_head_dim, a.q_per_kv) == (b.resolved_head_dim,
                                                 b.q_per_kv)
    assert T.segment_plan(a) == JT.segment_plan(b)
    assert a.replace(n_layers=3).n_layers == 3


def test_full_config_is_qwen3_0_6b():
    cfg = get_config("qwen3_0_6b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size) == \
        (28, 1024, 16, 8, 128, 3072, 151936)
    assert cfg.qk_norm and cfg.tie_embeddings and cfg.rope_theta == 1e6
    assert cfg.param_count() == 596_041_728


@pytest.mark.parametrize("name", ["deepseek_v3_671b", "deepseek-v3-671b"])
def test_unported_arch_raises(name):
    """deepseek-v3, the last of the reference's ten, resolves now under
    both spellings; a name that is none of the ten still raises."""
    for port, jref in ((get_config, jget_config),
                       (smoke_config, jsmoke_config)):
        assert dataclasses.asdict(port(name)) == dataclasses.asdict(
            jref(name))
    unknown = name.replace("v3", "v9")
    with pytest.raises(ValueError, match="unknown architecture"):
        get_config(unknown)
    with pytest.raises(ValueError, match="unknown architecture"):
        smoke_config(unknown)


@pytest.mark.parametrize("name", ["minicpm3_4b+mtp", "deepseek_v3_671b",
                                  "whisper_base+mtp", "qwen3_0_6b+mtp"])
def test_unported_blocks_raise(name):
    """The MTP head is ported: on MLA, on an encoder-decoder, on qwen3,
    and in deepseek-v3's SMOKE config as the reference has it (MLA/MoE
    blocks with the MTP head). ``check_supported`` takes each, and
    ``init_numpy_lm_params`` draws the reference's ``mtp`` leaves at its
    shapes (``jax.eval_shape`` of its ``init_lm``)."""
    arch, _, mtp = name.partition("+")
    cfg = jsmoke_config(arch)
    if mtp:
        cfg = cfg.replace(use_mtp=True)
    assert cfg.use_mtp
    T.check_supported(cfg)
    drawn = init_numpy_lm_params(cfg, seed=0)
    tree = jax.eval_shape(lambda: JT.init_lm(jax.random.PRNGKey(0), cfg))
    flat, _ = jax.tree_util.tree_flatten_with_path(tree["mtp"])
    want = {"mtp/" + "/".join(str(p.key) for p in path): tuple(leaf.shape)
            for path, leaf in flat}
    got = {k: v.shape for k, v in drawn.items() if k.startswith("mtp/")}
    assert got == want and "mtp/proj" in got
    assert got["mtp/proj"] == (2 * cfg.d_model, cfg.d_model)


# -------------------------------------------------------------- converter

def test_params_round_trip(twins):
    _, _, cfg, params, flat = twins
    back = lm_params_to_numpy(params, cfg)
    assert set(back) == set(flat)
    for key, arr in flat.items():
        np.testing.assert_array_equal(back[key], arr, err_msg=key)
    assert len(params["segments"]) == 1
    assert len(params["segments"][0]) == cfg.n_layers


def test_numpy_init_has_reference_layout(twins):
    _, _, cfg, _, flat = twins
    mine = init_numpy_lm_params(cfg, seed=3)
    assert {k: v.shape for k, v in mine.items()} == \
        {k: v.shape for k, v in flat.items()}
    assert all(v.dtype == np.float32 for v in mine.values())
    wq = mine["segments/0/mixer/wq"]
    assert np.abs(wq).max() <= 1 / np.sqrt(cfg.d_model)
    assert abs(mine["embed"].std() - 0.02) < 2e-3
    assert (mine["segments/0/mixer/q_norm/scale"] == 1).all()
    again = init_numpy_lm_params(cfg, seed=3)
    assert all(np.array_equal(mine[k], again[k]) for k in mine)


def test_port_init_lm_matches_layout(twins):
    _, _, cfg, params, _ = twins
    mine = T.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    flat = lm_params_to_numpy(mine, cfg)
    assert {k: v.shape for k, v in flat.items()} == \
        {k: v.shape for k, v in lm_params_to_numpy(params, cfg).items()}


# ----------------------------------------------------------- norms, MLP

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_reference(kind):
    rng = np.random.default_rng(8)
    x = (3 + rng.standard_normal((2, 5, 48))).astype(np.float32)
    p = {k: rng.standard_normal(v.shape).astype(np.float32)
         for k, v in layers.init_norm(kind, 48).items()}
    got = layers.apply_norm(kind, {k: torch.from_numpy(v)
                                   for k, v in p.items()},
                            torch.from_numpy(x), 1e-5)
    want = jlayers.apply_norm(kind, {k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("activation", ["silu", "gelu", "relu"])
def test_gated_mlp_matches_reference(activation):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    p = {k: rng.standard_normal(v.shape).astype(np.float32) / 6
         for k, v in layers.init_mlp(32, 64).items()}
    got = layers.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                     torch.from_numpy(x), activation)
    want = jlayers.mlp({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x), activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


# -------------------------------------------------------------- attention

@pytest.mark.parametrize("T_", [1, 17])
def test_attention_matches_reference(twins, T_):
    jcfg, jp, cfg, params, _ = twins
    jlayer = jax.tree.map(lambda a: a[0], jp["segments"][0]["mixer"])
    layer = params["segments"][0][0]["mixer"]
    x = np.random.default_rng(T_).standard_normal(
        (2, T_, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T_)[None], (2, T_)).astype(np.int32)
    got, cache = attn.attention(layer, cfg, torch.from_numpy(x),
                                torch.from_numpy(pos.copy()))
    want, jcache = jattn.attention(jlayer, jcfg, jnp.asarray(x),
                                   jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k),
                               atol=TOL, rtol=TOL)


def test_attention_decode_with_cache_matches_reference(twins):
    jcfg, jp, cfg, params, _ = twins
    jlayer = jax.tree.map(lambda a: a[0], jp["segments"][0]["mixer"])
    layer = params["segments"][0][0]["mixer"]
    rng = np.random.default_rng(2)
    ck = rng.standard_normal((2, 12, 2, 64)).astype(np.float32)
    cv = rng.standard_normal((2, 12, 2, 64)).astype(np.float32)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    pos = np.full((2, 1), 7, np.int32)
    cache = attn.KVCache(*(torch.from_numpy(a.copy()) for a in (ck, cv)))
    got, new = attn.attention(layer, cfg, torch.from_numpy(x),
                              torch.from_numpy(pos), cache=cache,
                              cache_index=7)
    want, jnew = jattn.attention(
        jlayer, jcfg, jnp.asarray(x), jnp.asarray(pos),
        cache=jattn.KVCache(jnp.asarray(ck), jnp.asarray(cv)),
        cache_index=jnp.int32(7))
    assert new.k is cache.k                      # updated in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(new.v.numpy(), np.asarray(jnew.v), atol=TOL,
                               rtol=TOL)


def test_rope_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 9)).astype(np.int32)
    got = attn.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    want = jattn.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------- prefill/decode

def test_prefill_matches_reference(twins):
    jcfg, jp, cfg, params, _ = twins
    toks = _tokens(0, 2, 24, cfg.vocab_size)
    want = np.asarray(JT.prefill(jp, jcfg, jnp.asarray(toks)).logits)
    out = T.prefill(params, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(out.logits.numpy(), want, atol=TOL, rtol=TOL)
    last = S.prefill_step(params, cfg, torch.from_numpy(toks))
    assert tuple(last.shape) == (2, cfg.vocab_size)
    np.testing.assert_allclose(last.numpy(), want[:, -1], atol=TOL, rtol=TOL)


def test_prefill_matches_reference_at_full_depth():
    """28 layers (qwen3-0.6b's depth) at a narrow width."""
    jcfg = jsmoke_config(ARCH).replace(**_narrow_deep())
    cfg = smoke_config(ARCH).replace(**_narrow_deep())
    jp = JT.init_lm(jax.random.PRNGKey(1), jcfg)
    flat, _ = _flatten_with_paths(jp)
    params = lm_params_from_numpy(flat, cfg, device="cpu")
    assert len(params["segments"][0]) == 28
    toks = _tokens(1, 2, 16, cfg.vocab_size)
    want = np.asarray(JT.prefill(jp, jcfg, jnp.asarray(toks)).logits)
    got = T.prefill(params, cfg, torch.from_numpy(toks)).logits.numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_decode_matches_reference_and_prefill(twins):
    """Each decode step's logits against the reference's decode_step and
    against the teacher-forced prefill at that position (the cache
    contract of tests/test_models.py)."""
    jcfg, jp, cfg, params, _ = twins
    S_ = 10
    toks = _tokens(3, 2, S_, cfg.vocab_size)
    full = T.prefill(params, cfg, torch.from_numpy(toks)).logits.numpy()
    caches = T.init_caches(cfg, 2, S_ + 4, device="cpu")
    jcaches = JT.init_caches(jcfg, 2, S_ + 4)
    for t in range(S_):
        lg, caches = T.decode_step(params, cfg, torch.from_numpy(
            toks[:, t:t + 1]), caches, t)
        jlg, jcaches = JT.decode_step(jp, jcfg, jnp.asarray(toks[:, t:t + 1]),
                                      jcaches, jnp.int32(t))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(lg.numpy()[:, 0], full[:, t], atol=TOL,
                                   rtol=TOL)
    np.testing.assert_allclose(caches[0].k.numpy(), np.asarray(jcaches[0].k),
                               atol=TOL, rtol=TOL)


def test_greedy_serve_loop_matches_reference(twins):
    """The launcher's loop (prompt fed token by token, then argmax) against
    the same loop over the reference's decode_step."""
    jcfg, jp, cfg, params, _ = twins
    P, gen = 6, 10
    prompts = _tokens(5, 3, P, cfg.vocab_size)
    got = serve.generate(params, cfg, torch.from_numpy(prompts), gen).numpy()
    assert got.shape == (3, P + gen)
    np.testing.assert_array_equal(got[:, :P], prompts)
    jcaches = JT.init_caches(jcfg, 3, P + gen)
    tok = jnp.asarray(prompts[:, :1])
    for t in range(P + gen - 1):
        lg, jcaches = JT.decode_step(jp, jcfg, tok, jcaches, jnp.int32(t))
        if t + 1 < P:
            tok = jnp.asarray(prompts[:, t + 1:t + 2])
            continue
        nxt = np.asarray(jnp.argmax(lg[:, -1], axis=-1))
        _assert_tokens(got[:, t + 1], nxt, lg[:, -1])
        tok = jnp.asarray(got[:, t + 1:t + 2])      # follow the port's path


def test_serve_step_returns_int32_tokens(twins):
    _, _, cfg, params, _ = twins
    caches = T.init_caches(cfg, 2, 4, device="cpu")
    tok = torch.zeros((2, 1), dtype=torch.int32)
    nxt, out = S.serve_step(params, cfg, tok, caches, 0)
    assert nxt.dtype == torch.int32 and tuple(nxt.shape) == (2, 1)
    assert out is caches


def test_launcher_cli_on_cpu(capsys):
    seqs = serve.main(["--smoke", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "5", "--gen", "4"])
    out = capsys.readouterr().out
    assert "arch=qwen3-smoke generated 2x4 tokens" in out
    assert "first sequence:" in out
    assert tuple(seqs.shape) == (2, 9)


# ------------------------------------------------------------- token data

def test_make_tokens_shape_range_determinism():
    a = make_tokens(torch.Generator().manual_seed(0), 4, 33, 512)
    b = make_tokens(torch.Generator().manual_seed(0), 4, 33, 512)
    c = make_tokens(torch.Generator().manual_seed(1), 4, 33, 512)
    assert a.dtype == torch.int32 and tuple(a.shape) == (4, 33)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < 512


def test_make_tokens_statistics():
    """Half the tokens follow the bigram (tok + 1) % vocab; the rest are
    Zipf draws, so low ranks dominate."""
    vocab = 1000
    toks = make_tokens(torch.Generator().manual_seed(2), 64, 256, vocab)
    share = (toks[:, 1:] == (toks[:, :-1] + 1) % vocab).float().mean()
    assert 0.47 < float(share) < 0.56
    counts = torch.bincount(toks[:, 0].long(), minlength=vocab)
    assert int(counts[0]) > int(counts[100:].max())


# ------------------------------------------------------------ entry points

def test_entry_points_need_an_explicit_cpu(twins):
    _, _, cfg, _, flat = twins
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_params_from_numpy(flat, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_lm(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_caches(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--smoke"])
    assert resolve_device("cpu").type == "cpu"


def test_lm_modules_import_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "import repro_torch.launch.serve, repro_torch.convert\n"
        "import repro_torch.launch.train, repro_torch.optim.schedules\n"
        "import repro_torch.checkpoint, repro_torch.checkpoint.npz\n"
        "import repro_torch.train_lm_on_codes\n"
        "import repro_torch.configs.whisper_base\n"
        "import repro_torch.configs.qwen3_moe_30b_a3b\n"
        "import repro_torch.configs.chameleon_34b\n"
        "import repro_torch.configs.deepseek_v3_671b\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(SRC)}, timeout=120)
    assert out.returncode == 0, out.stderr
