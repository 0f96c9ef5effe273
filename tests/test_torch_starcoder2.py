"""Port parity: starcoder2-3b (LayerNorm, tanh-GELU gated MLP, 12:1 GQA,
a 4,096-token sliding window) against ``repro.models.transformer`` on the
reference's own weights, carried across by ``repro_torch.convert``.

* The ``SMOKE`` config (2 layers, d 256, 4/2 heads of 64, window 128):
  prefill at T 300, so the window cuts every query past position 128,
  and decode steps past the window, each step's logits against the
  reference's ``decode_step`` and the port's own prefill.
* The full config's ``param_count`` (4,312,977,408) and every leaf's
  shape equal the reference's (from ``jax.eval_shape``: nothing is drawn
  at full width); the same for xlstm-350m.
* The flash kernel's plain version and the CPU model of its TF32
  three-pass tiles (``tests/test_torch_lm_kernels.py``) at the model's
  12:1 GQA with a window, and the window mask past position 4,096,
  against the reference's attention.

Tolerances: logits and attention outputs 2e-5 absolute and relative,
hidden states and KV caches 5e-5 (float32 sums in another order; logits
here are below 2 in magnitude), as the qwen3 and jamba slices' tests hold
them.
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
from repro.nn import attention as jattn  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.convert import (_norm_spec, lm_block_spec,  # noqa: E402
                                 lm_params_from_numpy, lm_params_to_numpy)
from repro_torch.distributed import steps as S  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import HEAD_DIMS  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.nn import attention as attn  # noqa: E402
from test_torch_lm_kernels import mm_tf32x3, tiled_attention  # noqa: E402

ARCH = "starcoder2_3b"
TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU tensors run far faster on one thread than on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what="", tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol, err_msg=what)


@pytest.fixture(scope="module")
def twins():
    jcfg, cfg = jsmoke_config(ARCH), smoke_config(ARCH)
    jp = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    flat, _ = _flatten_with_paths(jp)
    return jcfg, jp, cfg, lm_params_from_numpy(flat, cfg, device="cpu"), flat


def _tokens(seed, B, T_, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, T_)) \
        .astype(np.int32)


# ---------------------------------------------------------------- configs

@pytest.mark.parametrize("getter", ["get_config", "smoke_config"])
def test_config_equals_reference(getter):
    port = {"get_config": get_config, "smoke_config": smoke_config}[getter]
    jref = {"get_config": jget_config, "smoke_config": jsmoke_config}[getter]
    a, b = port(ARCH), jref(ARCH)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.layer_kinds() == b.layer_kinds()
    assert T.segment_plan(a) == JT.segment_plan(b)
    assert get_config("starcoder2-3b") == get_config(ARCH)


def _port_shapes(cfg):
    """Every reference key the port reads for ``cfg`` -> its shape."""
    V, d = cfg.vocab_size, cfg.d_model
    shapes = {"embed": (V, d)}
    shapes.update({k: s for k, (s, _) in
                   _norm_spec("final_norm", cfg.norm, d).items()})
    if not cfg.tie_embeddings:
        shapes["head"] = (d, V)
    for s, (mixer, ffn, n) in enumerate(T.segment_plan(cfg)):
        for key, (shape, _) in lm_block_spec(cfg, mixer, ffn).items():
            shapes[f"segments/{s}/{key}"] = (n,) + shape
    return shapes


@pytest.mark.parametrize("arch,count", [("starcoder2_3b", 4_312_977_408),
                                        ("xlstm_350m", 319_938_492)])
def test_full_config_counts_and_leaf_shapes(arch, count):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert cfg.param_count() == jcfg.param_count() == count
    tree = jax.eval_shape(lambda: JT.init_lm(jax.random.PRNGKey(0), jcfg))
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    want = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): tuple(leaf.shape) for path, leaf in flat}
    assert _port_shapes(cfg) == want
    T.check_supported(cfg)


def test_full_config_is_starcoder2_3b():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size,
            cfg.sliding_window, cfg.rope_theta) == \
        (30, 3072, 24, 2, 128, 12288, 49152, 4096, 1e5)
    assert cfg.norm == "layernorm" and cfg.activation == "gelu"
    assert not cfg.tie_embeddings and cfg.q_per_kv == 12
    assert cfg.resolved_head_dim in HEAD_DIMS


# -------------------------------------------------------------- converter

def test_params_round_trip(twins):
    _, _, cfg, params, flat = twins
    back = lm_params_to_numpy(params, cfg)
    assert set(back) == set(flat)
    for key, arr in flat.items():
        np.testing.assert_array_equal(back[key], arr, err_msg=key)
    bp = params["segments"][0][0]
    assert set(bp["pre_norm"]) == {"scale", "bias"}     # LayerNorm


# ---------------------------------------------------------- prefill/decode

def test_prefill_matches_reference_past_the_window(twins):
    jcfg, jp, cfg, params, _ = twins
    toks = _tokens(0, 2, 300, cfg.vocab_size)
    want = JT.prefill(jp, jcfg, jnp.asarray(toks))
    out = T.prefill(params, cfg, torch.from_numpy(toks))
    _close(out.logits.numpy(), want.logits, "logits")
    _close(out.hidden.numpy(), want.hidden, "hidden", tol=5e-5)
    last = S.prefill_step(params, cfg, torch.from_numpy(toks))
    _close(last.numpy(), np.asarray(want.logits)[:, -1], "last")


_jdecode = jax.jit(JT.decode_step, static_argnums=1)


def test_decode_past_the_window_matches_reference_and_prefill(twins):
    """160 decode steps from an empty cache, 32 past the 128-token window:
    each step's logits against the reference's step and the port's
    prefill of the same tokens, then the KV caches."""
    jcfg, jp, cfg, params, _ = twins
    S_ = 160
    toks = _tokens(3, 2, S_, cfg.vocab_size)
    caches = T.init_caches(cfg, 2, S_, device="cpu")
    jcaches = JT.init_caches(jcfg, 2, S_)
    steps = []
    for t in range(S_):
        lg, caches = T.decode_step(params, cfg, torch.from_numpy(
            toks[:, t:t + 1]), caches, t)
        jlg, jcaches = _jdecode(jp, jcfg, jnp.asarray(toks[:, t:t + 1]),
                               jcaches, jnp.int32(t))
        _close(lg.numpy(), jlg, f"logits {t}")
        steps.append(lg)
    pre = T.prefill(params, cfg, torch.from_numpy(toks)).logits
    _close(torch.cat(steps, 1).numpy(), pre.numpy(), "decode vs prefill")
    for si, (mine, theirs) in enumerate(zip(caches, jcaches)):
        for name, a, b in zip(mine._fields, mine, theirs):
            _close(a.numpy(), b, f"segment {si} {name}", tol=5e-5)


def test_launcher_cli_on_cpu(capsys):
    seqs = serve.main(["--arch", "starcoder2-3b", "--smoke", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "4",
                       "--gen", "3"])
    assert tuple(seqs.shape) == (2, 7)
    assert "arch=starcoder2-smoke" in capsys.readouterr().out


# ------------------------------------------------ the windowed flash path

def _qkv(seed, B, T_, hq, hkv, d):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, T_, hq, d)).astype(np.float32),
            r.standard_normal((B, T_, hkv, d)).astype(np.float32),
            r.standard_normal((B, T_, hkv, d)).astype(np.float32))


def _reference_attend(q, k, v, window):
    """The reference's attention core (GQA by repeating k and v)."""
    return np.asarray(jattn.attend(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True, window=window,
                                   force_chunked=False))


def test_flash_at_12_to_1_gqa_with_a_window():
    """Query head h reads KV head h // 12: the plain version, the CPU
    model of the kernel's TF32 three-pass tiles and the port's decode-path
    attention, each against the reference's attention."""
    q, k, v = _qkv(5, 1, 300, 24, 2, 128)
    want = _reference_attend(q, k, v, 128)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    _close(ref.flash_attention_ref(tq, tk, tv, causal=True, window=128)
           .numpy(), want, "plain")
    _close(ops.flash_attention(tq, tk, tv, causal=True, window=128).numpy(),
           want, "ops")
    _close(tiled_attention(tq, tk, tv, mm_tf32x3, causal=True, window=128)
           .numpy(), want, "tf32x3 tiles")
    _close(attn._attend_full(tq, tk, tv, causal=True, window=128).numpy(),
           want, "attend_full")


def test_window_mask_past_position_4096():
    """At the model's window: keys kpos > qpos - 4096 only, so queries past
    4,096 lose their first keys; the plain flash version against the
    reference and against attending the window's keys alone."""
    T_, W = 4200, 4096
    q, k, v = _qkv(6, 1, T_, 1, 1, 64)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = ref.flash_attention_ref(tq, tk, tv, causal=True, window=W).numpy()
    _close(got, _reference_attend(q, k, v, W), "plain vs reference")
    full = ref.flash_attention_ref(tq, tk, tv, causal=True).numpy()
    assert np.abs(got[:, W:] - full[:, W:]).max() > 1e-3   # the window cut
    np.testing.assert_array_equal(got[:, :W], full[:, :W])
    t = T_ - 1                       # the last query sees keys t-W+1 .. t
    alone = ref.flash_attention_ref(tq[:, t:t + 1], tk[:, t - W + 1:t + 1],
                                    tv[:, t - W + 1:t + 1], causal=False)
    _close(got[:, t:t + 1], alone.numpy(), "last query alone")
