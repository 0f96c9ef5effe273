"""Port parity: Multi-head Latent Attention (``repro_torch.nn.mla``) against
``repro.nn.mla`` on the reference's own weights and numpy inputs.

Widths: minicpm3's SMOKE MLA (d 256, 4 heads, q_lora 64, kv_lora 32, q/k
48 = 32 + 16 RoPE, v 32), the same without a q LoRA (``wq``), and the
reference's own MLA test config (``tests/test_nn.py::_mla_cfg``). The
prefill is the expanded path, which the port runs at one of the flash
kernel's head dims (v, and q/k where narrower, padded with zero columns;
q rescaled for the kernel's scale) and slices back; the decode step is
the absorbed path over the (c_kv, k_rope) cache.

Tolerances: port against reference 2e-5 absolute and relative (float32
products and sums in another order); the padded plain path against the
unpadded one 1e-6 (the same sums but for zero terms); the absorbed decode
chain against the expanded prefill under the reference's own rule (atol
1e-3, rtol 1e-2: the folding reorders the products).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.configs.base import MLAConfig as JMLAConfig  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro.nn import mla as JM  # noqa: E402
from repro.checkpoint.npz import _flatten_with_paths  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import MLAConfig, ModelConfig  # noqa: E402
from repro_torch.convert import lm_block_spec  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (BWD_HEAD_DIMS,  # noqa: E402
                                                 HEAD_DIMS,
                                                 flash_attention_bwd_cuda,
                                                 flash_attention_cuda)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.nn import attention as attn  # noqa: E402
from repro_torch.nn import mla as M  # noqa: E402
from test_torch_autograd import _card, _flash_args  # noqa: E402

TOL = 2e-5
PAD_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU tensors run far faster on one thread than on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _test_nn_cfg(pkg_cfg, pkg_mla):
    """``tests/test_nn.py::_mla_cfg`` in either package."""
    return pkg_cfg(d_model=64, n_heads=4, n_kv_heads=4, use_mla=True,
                   mla=pkg_mla(q_lora_rank=32, kv_lora_rank=16,
                               qk_nope_head_dim=16, qk_rope_head_dim=8,
                               v_head_dim=16))


def _cfgs(kind):
    """(reference config, port config) of ``kind``."""
    if kind == "smoke":
        return jsmoke_config("minicpm3_4b"), smoke_config("minicpm3_4b")
    if kind == "smoke_no_q_lora":
        j, p = _cfgs("smoke")
        return (j.replace(mla=dataclasses.replace(j.mla, q_lora_rank=0)),
                p.replace(mla=dataclasses.replace(p.mla, q_lora_rank=0)))
    return (_test_nn_cfg(JModelConfig, JMLAConfig),
            _test_nn_cfg(ModelConfig, MLAConfig))


KINDS = ("smoke", "smoke_no_q_lora", "test_nn")


def _twins(kind, seed=0):
    """The reference's MLA weights and the same arrays as port tensors."""
    jcfg, cfg = _cfgs(kind)
    jp = JM.init_mla(jax.random.PRNGKey(seed), jcfg)
    flat, _ = _flatten_with_paths(jp)
    params = {}
    for key, arr in flat.items():
        node = params
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = torch.tensor(np.asarray(arr))
    return jcfg, jp, cfg, params, flat


def _inputs(cfg, B, T_, seed=1):
    x = np.random.default_rng(seed).standard_normal(
        (B, T_, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T_)[None], (B, T_)).astype(np.int32)
    return x, pos


def _port(x, pos):
    return torch.from_numpy(x), torch.from_numpy(pos.astype(np.int64))


# ---------------------------------------------------------------- weights

@pytest.mark.parametrize("kind", KINDS)
def test_params_layout_equals_reference(kind):
    """``init_mla`` and the converter's block spec name the reference's
    keys at its shapes; ``wq`` replaces the LoRA pair when q_lora_rank is
    0."""
    _, _, cfg, _, flat = _twins(kind)
    want = {k: tuple(np.shape(v)) for k, v in flat.items()}
    spec = {k[len("mixer/"):]: s for k, (s, _) in
            lm_block_spec(cfg, "mla", "dense").items()
            if k.startswith("mixer/")}
    assert spec == want
    port = M.init_mla(cfg, generator=torch.Generator().manual_seed(0))
    got = {}
    for k, v in port.items():
        if isinstance(v, dict):
            got.update({f"{k}/{kk}": tuple(vv.shape)
                        for kk, vv in v.items()})
        else:
            got[k] = tuple(v.shape)
    assert got == want
    assert ("wq" in port) == (not cfg.mla.q_lora_rank)


# --------------------------------------------------------------- prefill

@pytest.mark.parametrize("kind", KINDS)
def test_prefill_matches_reference(kind):
    """The expanded path (padded on the flash entry, sliced back) against
    the reference's, and the cache it returns. In the SMOKE configs RoPE's
    16 differs from the resolved head dim 64: the mixer's own angles."""
    jcfg, jp, cfg, params, _ = _twins(kind)
    x, pos = _inputs(cfg, 2, 37)
    want, jcache = JM.mla_attention(jp, jcfg, jnp.asarray(x),
                                    jnp.asarray(pos))
    got, cache = M.mla_attention(params, cfg, *_port(x, pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    for g, w in zip(cache, jcache):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("widths,D", [((64, 32, 64), 96),
                                      ((32, 16, 32), 64),
                                      ((128, 64, 128), 192)])
def test_prefill_runs_the_flash_entry_at_a_kernel_width(widths, D,
                                                         monkeypatch):
    """The prefill calls ``ops.flash_attention`` once, with q, k and v all
    at one head dim the kernel takes: q/k's own width at minicpm3-4b's and
    deepseek-v3's MLA widths (96 and 192, v 64 and 128 zero-padded) and
    the SMOKE config's 48 padded to 64. Never the plain
    ``_attend_full``."""
    dn, dr, dv = widths
    cfg = ModelConfig(d_model=128, n_heads=2, n_kv_heads=2, use_mla=True,
                      mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                    qk_nope_head_dim=dn, qk_rope_head_dim=dr,
                                    v_head_dim=dv))
    assert attn.flash_width(dn + dr, dv) == D
    calls = []
    real = ops.flash_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape, k.shape, v.shape, kw))
        return real(q, k, v, **kw)

    def refuse(*a, **kw):
        raise AssertionError("the MLA prefill fell back to _attend_full")

    monkeypatch.setattr(ops, "flash_attention", spy)
    monkeypatch.setattr(attn, "_attend_full", refuse)
    params = M.init_mla(cfg, generator=torch.Generator().manual_seed(0))
    x = torch.randn((2, 20, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    pos = torch.arange(20)[None].expand(2, 20)
    out, _ = M.mla_attention(params, cfg, x, pos)
    assert out.shape == (2, 20, cfg.d_model)
    assert calls == [((2, 20, 2, D),) * 3 + ({"causal": True,
                                              "window": 0},)]
    assert D in HEAD_DIMS


@pytest.mark.parametrize("causal,tk", [(True, None), (False, 50)])
def test_padded_v_equals_unpadded_plain(causal, tk):
    """The flash entry's plain version on v padded with zero columns,
    sliced back, against the plain paths on the unpadded v (the
    reference's ``_attend_full`` and the port's ``flash_attention_ref``,
    which both take a narrower v), within 1e-6; the padded columns come
    out exactly 0."""
    rng = np.random.default_rng(5)
    B, T_, H, D, Dv = 2, 40, 3, 96, 64
    Tk = T_ if tk is None else tk
    q = rng.standard_normal((B, T_, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Tk, H, D)).astype(np.float32)
    v = rng.standard_normal((B, Tk, H, Dv)).astype(np.float32)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    padded = ops.flash_attention(qt, kt, torch.nn.functional.pad(
        vt, (0, D - Dv)), causal=causal)
    assert not padded[..., Dv:].any()
    got = padded[..., :Dv].numpy()
    plain = ref.flash_attention_ref(qt, kt, vt, causal=causal).numpy()
    want = jattn._attend_full(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, q_offset=0, window=0)
    np.testing.assert_allclose(got, plain, atol=PAD_TOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(want), atol=PAD_TOL, rtol=0)


# ---------------------------------------------------------------- decode

_jmla = jax.jit(JM.mla_attention, static_argnums=1)


@pytest.mark.parametrize("kind", KINDS)
def test_decode_matches_reference(kind):
    """A chain of absorbed decode steps from an empty cache: each step's
    output against the reference's step, and the cache's two fields after
    it."""
    jcfg, jp, cfg, params, _ = _twins(kind)
    B, L = 2, 12
    x, pos = _inputs(cfg, B, L, seed=3)
    cache = M.init_mla_cache(cfg, B, L, device="cpu")
    jcache = JM.init_mla_cache(jcfg, B, L)
    for t in range(L):
        got, cache2 = M.mla_attention(params, cfg, *_port(x[:, t:t + 1],
                                                          pos[:, t:t + 1]),
                                      cache=cache, cache_index=t)
        assert cache2 is cache
        want, jcache = _jmla(jp, jcfg, jnp.asarray(x[:, t:t + 1]),
                             jnp.asarray(pos[:, t:t + 1]), cache=jcache,
                             cache_index=jnp.int32(t))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL, err_msg=f"step {t}")
    for g, w in zip(cache, jcache):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_absorbed_chain_matches_expanded(kind):
    """The reference's own proof of the wkv_b folding, on the port: the
    absorbed decode, position by position, against the expanded prefill
    (``tests/test_nn.py::test_mla_absorbed_decode_matches_expanded``'s
    rule), and the cache it fills equal to the prefill's latents."""
    _, _, cfg, params, _ = _twins(kind)
    B, L = 2, 8
    x, pos = _port(*_inputs(cfg, B, L, seed=4))
    full, pre = M.mla_attention(params, cfg, x, pos)
    cache = M.init_mla_cache(cfg, B, L, device="cpu")
    outs = []
    for t in range(L):
        o, cache = M.mla_attention(params, cfg, x[:, t:t + 1],
                                   pos[:, t:t + 1], cache=cache,
                                   cache_index=t)
        outs.append(o)
    np.testing.assert_allclose(full.numpy(), torch.cat(outs, 1).numpy(),
                               atol=1e-3, rtol=1e-2)
    for g, w in zip(cache, pre):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TOL, rtol=TOL)


def test_cache_holds_latents_only():
    """The cache is (c_kv, k_rope) at kv_lora_rank and qk_rope_head_dim:
    288 floats a token and layer at minicpm3-4b, against 2 x 40 x 96 for
    expanded keys and values."""
    cfg = smoke_config("minicpm3_4b")
    cache = M.init_mla_cache(cfg, 3, 17, device="cpu")
    assert cache._fields == ("c_kv", "k_rope")
    assert cache.c_kv.shape == (3, 17, cfg.mla.kv_lora_rank)
    assert cache.k_rope.shape == (3, 17, cfg.mla.qk_rope_head_dim)
    assert not cache.c_kv.any() and not cache.k_rope.any()
    caches = T.init_caches(cfg, 3, 17, device="cpu")
    assert [type(c) for c in caches] == [M.MLACache]
    assert caches[0].c_kv.shape == (cfg.n_layers, 3, 17,
                                    cfg.mla.kv_lora_rank)
    full = get_config("minicpm3_4b").mla
    assert full.kv_lora_rank + full.qk_rope_head_dim == 288


# ------------------------------------------------------- kernel refusals

@pytest.mark.parametrize("d", [32, 48, 160, 224, 512])
def test_flash_forward_refuses_other_head_dims(d):
    """A head dim the forward kernel is not built for raises on the card
    (reached without one through a CPU tensor that reports cuda)."""
    q, k, v = _card(1, 4, 2, d), _card(1, 4, 1, d), _card(1, 4, 1, d)
    with pytest.raises(ValueError, match=rf"the kernel takes head dims "
                       rf"\(64, 96, 128, 192, 256\), got {d}"):
        flash_attention_cuda(q, k, v)


@pytest.mark.parametrize("d", [96, 192, 256])
def test_flash_backward_still_refuses_new_head_dims(d, monkeypatch):
    """The backward kernel takes the forward's head dims (64, 96, 128,
    192, 256), so MLA's and gemma-7b's widths train: at 96, 192 and 256 a
    call passes every argument check and reaches the kernel library (a
    stand-in here that raises), where another head dim is refused with the
    forward's list."""
    from repro_torch.kernels import _build

    def library():
        raise LookupError("reached the launch")

    monkeypatch.setattr(_build, "library", library)
    assert d in HEAD_DIMS and BWD_HEAD_DIMS == HEAD_DIMS
    args = {n: _card(*t.shape[:-1], d) if n != "lse" else t
            for n, t in _flash_args().items()}
    with pytest.raises(LookupError, match="reached the launch"):
        flash_attention_bwd_cuda(**args)
    args = {n: _card(*t.shape[:-1], d + 16) if n != "lse" else t
            for n, t in _flash_args().items()}
    with pytest.raises(ValueError, match=rf"the kernel takes head dims "
                       rf"\(64, 96, 128, 192, 256\), got {d + 16}"):
        flash_attention_bwd_cuda(**args)
