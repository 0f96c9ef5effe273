"""Port parity: qwen3-moe-30b-a3b (128 experts top-8, GQA 32:4, qk-norm),
chameleon-34b (early fusion, GQA 64:8, qk-norm), gemma-7b (16 heads of
256, GeGLU, tied), minicpm3-4b (Multi-head Latent Attention) and
deepseek-v3-671b (MLA, 256 sigmoid-routed experts top-8 with a shared
one, the MTP head) against
``repro.models.transformer`` on the reference's own weights, carried
across by ``repro_torch.convert``.

* ``CONFIG`` and ``SMOKE`` equal the reference's; the full configs'
  parameter counts and every leaf's shape (``jax.eval_shape``: nothing is
  drawn at full width) are the reference's; the flash kernel takes the
  width its attention runs at (MLA's q/k width, its v padded to it).
* At each ``SMOKE`` config: the converter's round trip bit for bit;
  prefill logits within 1e-3 of the largest logit; a chain of decode steps
  from an empty cache against the reference's teacher-forced logits and
  its own decode steps, within the same rule.
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
from repro_torch.launch import serve  # noqa: E402
from repro_torch.kernels.flash_attention import HEAD_DIMS  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from test_torch_whisper import _port_shapes  # noqa: E402

ARCHS = ("qwen3_moe_30b_a3b", "chameleon_34b", "gemma_7b", "minicpm3_4b",
         "deepseek_v3_671b")
LOGIT_RTOL = 1e-3                # of the largest |logit|


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU tensors run far faster on one thread than on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_TWINS = {}


def _twins(arch):
    """The reference's SMOKE weights, and the same arrays in the port."""
    if arch not in _TWINS:
        jcfg, cfg = jsmoke_config(arch), smoke_config(arch)
        jp = JT.init_lm(jax.random.PRNGKey(0), jcfg)
        flat, _ = _flatten_with_paths(jp)
        _TWINS[arch] = (jcfg, jp, cfg,
                        lm_params_from_numpy(flat, cfg, device="cpu"), flat)
    return _TWINS[arch]


def _tokens(seed, B, T_, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, T_)) \
        .astype(np.int32)


def _close_of_max(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    limit = LOGIT_RTOL * np.abs(want).max()
    err = np.abs(got - want).max()
    assert got.shape == want.shape and err <= limit, \
        f"{what}: differs by {err} > {limit}"


# ---------------------------------------------------------------- configs

@pytest.mark.parametrize("getter", ["get_config", "smoke_config"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch, getter):
    port = {"get_config": get_config, "smoke_config": smoke_config}[getter]
    jref = {"get_config": jget_config, "smoke_config": jsmoke_config}[getter]
    a, b = port(arch), jref(arch)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.layer_kinds() == b.layer_kinds()
    assert T.segment_plan(a) == JT.segment_plan(b)


@pytest.mark.parametrize("alias,arch", [("qwen3-moe-30b-a3b", ARCHS[0]),
                                        ("chameleon-34b", ARCHS[1]),
                                        ("gemma-7b", ARCHS[2]),
                                        ("minicpm3-4b", ARCHS[3]),
                                        ("deepseek-v3-671b", ARCHS[4])])
def test_aliases(alias, arch):
    assert get_config(alias) == get_config(arch)
    assert smoke_config(alias) == smoke_config(arch)


@pytest.mark.parametrize("arch,count,width,q_per_kv", [
    ("qwen3_moe_30b_a3b", 30_532_108_288, 128, 8),
    ("chameleon_34b", 34_293_415_936, 128, 8),
    ("gemma_7b", 8_537_677_824, 256, 1),
    ("minicpm3_4b", 4_261_836_800, 96, 1),
    ("deepseek_v3_671b", 671_628_154_880, 192, 1)])
def test_full_config_counts_and_leaf_shapes(arch, count, width, q_per_kv):
    """The reference's analytic count, the port's leaf shapes against
    ``jax.eval_shape`` of the reference's init, and the width the flash
    kernel runs the attention at (MLA's q/k width) among its head dims.
    deepseek-v3's leaves include its MTP head's (``mtp/...``)."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert cfg.param_count() == jcfg.param_count() == count
    tree = jax.eval_shape(lambda: JT.init_lm(jax.random.PRNGKey(0), jcfg))
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    want = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): tuple(leaf.shape) for path, leaf in flat}
    assert _port_shapes(cfg) == want
    T.check_supported(cfg)
    attn = cfg.mla.qk_head_dim if cfg.use_mla else cfg.resolved_head_dim
    assert attn == width in HEAD_DIMS and cfg.q_per_kv == q_per_kv


# -------------------------------------------------------- smoke parity

@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip(arch):
    _, _, cfg, params, flat = _twins(arch)
    back = lm_params_to_numpy(params, cfg)
    assert set(back) == set(flat)
    for key, arr in flat.items():
        assert back[key].tobytes() == np.asarray(arr).tobytes(), key


@pytest.mark.parametrize("arch", ARCHS)
def test_init_numpy_params_round_trip(arch):
    """``init_numpy_lm_params`` draws the reference's keys at its shapes,
    and they go into the port and back bit for bit."""
    _, _, cfg, _, flat = _twins(arch)
    drawn = init_numpy_lm_params(cfg, seed=1)
    assert {k: v.shape for k, v in drawn.items()} == \
        {k: np.shape(v) for k, v in flat.items()}
    back = lm_params_to_numpy(lm_params_from_numpy(drawn, cfg, device="cpu"),
                              cfg)
    for key, arr in drawn.items():
        assert back[key].tobytes() == arr.tobytes(), key


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    jcfg, jp, cfg, params, _ = _twins(arch)
    toks = _tokens(0, 2, 40, cfg.vocab_size)
    want = JT.prefill(jp, jcfg, jnp.asarray(toks))
    out = T.prefill(params, cfg, torch.from_numpy(toks))
    _close_of_max(out.logits.numpy(), want.logits, "logits")
    last = S.prefill_step(params, cfg, torch.from_numpy(toks))
    _close_of_max(last.numpy(), np.asarray(want.logits)[:, -1], "last")


_jdecode = jax.jit(JT.decode_step, static_argnums=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference_and_teacher_forced(arch):
    """16 decode steps from an empty cache: each step's logits against the
    reference's decode step and its teacher-forced prefill (the SMOKE MoE's
    capacity factor 4 keeps its prefill dropless)."""
    jcfg, jp, cfg, params, _ = _twins(arch)
    L = 16
    toks = _tokens(3, 2, L, cfg.vocab_size)
    want = np.asarray(JT.prefill(jp, jcfg, jnp.asarray(toks)).logits)
    caches = T.init_caches(cfg, 2, L, device="cpu")
    jcaches = JT.init_caches(jcfg, 2, L)
    for t in range(L):
        lg, caches = T.decode_step(params, cfg, torch.from_numpy(
            toks[:, t:t + 1]), caches, t)
        jlg, jcaches = _jdecode(jp, jcfg, jnp.asarray(toks[:, t:t + 1]),
                               jcaches, jnp.int32(t))
        _close_of_max(lg.numpy(), jlg, f"step {t} vs decode")
        _close_of_max(lg.numpy(), want[:, t:t + 1],
                      f"step {t} vs teacher-forced")


@pytest.mark.parametrize("alias", ["gemma-7b", "minicpm3-4b",
                                   "deepseek-v3-671b"])
def test_launcher_cli_on_cpu(alias, capsys):
    seqs = serve.main(["--arch", alias, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "4", "--gen", "3"])
    assert tuple(seqs.shape) == (2, 7)
    assert f"arch={smoke_config(alias).name}" in capsys.readouterr().out
