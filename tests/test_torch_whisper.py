"""Port parity: whisper-base's encoder-decoder against
``repro.models.transformer`` on the reference's own weights, carried
across by ``repro_torch.convert``, at the ``SMOKE`` config (2 + 2 layers,
d 256, 4 heads of 64, LayerNorm, 64 frames).

* ``encode_audio`` (non-causal self-attention with RoPE on q and k)
  within 1e-4 of its output's largest magnitude;
* ``cross_attention`` alone, T queries against 64 frames (T 7, and a
  decode step's T 1), within 2e-5 absolute and relative;
* ``prefill`` logits with ``enc_out``, a ``decode_step`` chain against the
  reference's teacher-forced logits and its own steps, and ``lm_loss``,
  each within 1e-3 of the largest logit (the loss within 1e-5 relative);
* the converter's round trip bit for bit, and the full config's leaf
  shapes and parameter count;
* the launcher's frames equal ``jax.random.normal(PRNGKey(seed), ...)``
  bit for bit;
* ``build_train_step`` refuses an encoder-decoder, ``check_supported``
  still refuses MLA and MTP;
* the CPU model of the flash kernel's TF32 tiles at Tq != Tk against the
  reference's attention core, and (on a card only) the kernel itself.
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
from repro_torch.configs import TrainConfig, get_config, smoke_config  # noqa: E402,E501
from repro_torch.convert import (_stacks, _top_spec,  # noqa: E402
                                 init_numpy_lm_params, lm_params_from_numpy,
                                 lm_params_to_numpy)
from repro_torch.distributed import steps as S  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.nn import attention as attn  # noqa: E402
from test_torch_lm_kernels import mm_tf32x3, tiled_attention  # noqa: E402

ARCH = "whisper_base"
TOL = 2e-5
ENC_RTOL = 1e-4                  # of the encoder output's largest |value|
LOGIT_RTOL = 1e-3                # of the largest |logit|


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU tensors run far faster on one thread than on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def twins():
    jcfg, cfg = jsmoke_config(ARCH), smoke_config(ARCH)
    jp = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    flat, _ = _flatten_with_paths(jp)
    return jcfg, jp, cfg, lm_params_from_numpy(flat, cfg, device="cpu"), flat


@pytest.fixture(scope="module")
def encoded(twins):
    """Frames (2, 64, 256) from numpy, and both packages' encoder output."""
    jcfg, jp, cfg, params, _ = twins
    frames = np.random.default_rng(5).standard_normal(
        (2, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    jenc = JT.encode_audio(jp, jcfg, jnp.asarray(frames))
    with torch.no_grad():
        enc = T.encode_audio(params, cfg, torch.from_numpy(frames))
    return jenc, enc


def _tokens(seed, B, T_, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, T_)) \
        .astype(np.int32)


def _close_of_max(got, want, rtol, what):
    got, want = np.asarray(got), np.asarray(want)
    limit = rtol * np.abs(want).max()
    err = np.abs(got - want).max()
    assert got.shape == want.shape and err <= limit, \
        f"{what}: differs by {err} > {limit}"


# ---------------------------------------------------------------- configs

@pytest.mark.parametrize("getter", ["get_config", "smoke_config"])
def test_config_equals_reference(getter):
    port = {"get_config": get_config, "smoke_config": smoke_config}[getter]
    jref = {"get_config": jget_config, "smoke_config": jsmoke_config}[getter]
    a, b = port(ARCH), jref(ARCH)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.param_count() == b.param_count()
    assert T.segment_plan(a) == JT.segment_plan(b)
    assert get_config("whisper-base") == get_config(ARCH)


def test_full_config_leaf_shapes_and_count():
    """The full config as the reference builds it (``jax.eval_shape``:
    nothing drawn): the port's converter names every leaf with its shape,
    ~0.11 B parameters with the untied head."""
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    tree = jax.eval_shape(lambda: JT.init_lm(jax.random.PRNGKey(0), jcfg))
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    want = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): tuple(leaf.shape) for path, leaf in flat}
    assert _port_shapes(cfg) == want
    n = sum(int(np.prod(s)) for s in want.values())
    assert 0.10e9 < n < 0.12e9
    assert (cfg.n_layers, cfg.n_encoder_layers, cfg.d_model, cfg.n_heads,
            cfg.resolved_head_dim, cfg.vocab_size, cfg.n_audio_frames) == \
        (6, 6, 512, 8, 64, 51865, 1500)


def _port_shapes(cfg):
    """Every reference key the port's converter reads for ``cfg`` -> its
    shape."""
    V, d = cfg.vocab_size, cfg.d_model
    shapes = {"embed": (V, d)}
    if not cfg.tie_embeddings:
        shapes["head"] = (d, V)
    shapes.update({k: s for k, (s, _) in _top_spec(cfg).items()})
    for prefix, n, spec in _stacks(cfg):
        shapes.update({f"{prefix}/{k}": (n,) + s
                       for k, (s, _) in spec.items()})
    return shapes


# -------------------------------------------------------------- converter

def test_params_round_trip(twins):
    """The reference's whisper-smoke tree (decoder blocks with cross_norm
    and cross, the encoder stack, enc_final_norm) round-trips bit for
    bit; init_numpy_lm_params draws the same keys and shapes."""
    _, _, cfg, params, flat = twins
    assert any(k.startswith("encoder/") for k in flat)
    assert "segments/0/cross/wq" in flat and "enc_final_norm/bias" in flat
    back = lm_params_to_numpy(params, cfg)
    assert set(back) == set(flat)
    for key, arr in flat.items():
        assert back[key].tobytes() == np.asarray(arr).tobytes(), key
    assert len(params["encoder"]) == cfg.n_encoder_layers
    mine = init_numpy_lm_params(cfg, seed=3)
    assert {k: v.shape for k, v in mine.items()} == \
        {k: np.shape(v) for k, v in flat.items()}


def test_init_lm_has_the_reference_tree():
    cfg = smoke_config(ARCH)
    params = T.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    flat = lm_params_to_numpy(params, cfg)
    want = init_numpy_lm_params(cfg, seed=0)
    assert {k: v.shape for k, v in flat.items()} == \
        {k: v.shape for k, v in want.items()}


# --------------------------------------------------------------- encoder

def test_encode_audio_matches_reference(encoded):
    jenc, enc = encoded
    assert bool(torch.isfinite(enc).all())
    _close_of_max(enc.numpy(), jenc, ENC_RTOL, "encode_audio")


@pytest.mark.parametrize("Tq", [7, 1])
def test_cross_attention_matches_reference(twins, encoded, Tq):
    """T queries against the 64 frames: the flash path's plain version at
    T 7, the decode step's plain path at T 1."""
    jcfg, jp, cfg, params, _ = twins
    jenc, enc = encoded
    x = np.random.default_rng(Tq).standard_normal(
        (2, Tq, cfg.d_model)).astype(np.float32)
    jblock = jax.tree.map(lambda a: a[1], jp["segments"][0]["cross"])
    want = jattn.cross_attention(jblock, jcfg, jnp.asarray(x), jenc)
    got = attn.cross_attention(params["segments"][0][1]["cross"], cfg,
                               torch.from_numpy(x), enc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


# ---------------------------------------------------- prefill/decode/loss

def test_prefill_matches_reference(twins, encoded):
    jcfg, jp, cfg, params, _ = twins
    jenc, enc = encoded
    toks = _tokens(0, 2, 24, cfg.vocab_size)
    want = JT.prefill(jp, jcfg, jnp.asarray(toks), enc_out=jenc)
    out = T.prefill(params, cfg, torch.from_numpy(toks), enc_out=enc)
    _close_of_max(out.logits.numpy(), want.logits, LOGIT_RTOL, "logits")
    last = S.prefill_step(params, cfg, torch.from_numpy(toks), enc_out=enc)
    _close_of_max(last.numpy(), np.asarray(want.logits)[:, -1], LOGIT_RTOL,
                  "prefill_step")
    # without enc_out the decoder blocks skip cross-attention, as the
    # reference's do: another function
    plain = T.prefill(params, cfg, torch.from_numpy(toks)).logits
    assert float((plain - out.logits).abs().max()) > 1e-2


_jdecode = jax.jit(JT.decode_step, static_argnums=1)


def test_decode_chain_matches_teacher_forced(twins, encoded):
    """12 serve steps from an empty cache: each step's logits against the
    reference's teacher-forced prefill and its own decode step; the
    greedy tokens of the serve step against the reference's argmax except
    at near ties."""
    jcfg, jp, cfg, params, _ = twins
    jenc, enc = encoded
    L = 12
    toks = _tokens(3, 2, L, cfg.vocab_size)
    want = np.asarray(JT.prefill(jp, jcfg, jnp.asarray(toks),
                                 enc_out=jenc).logits)
    caches = T.init_caches(cfg, 2, L, device="cpu")
    jcaches = JT.init_caches(jcfg, 2, L)
    for t in range(L):
        tok = torch.from_numpy(toks[:, t:t + 1])
        lg, _ = T.decode_step(params, cfg, tok, caches, t, enc_out=enc)
        jlg, jcaches = _jdecode(jp, jcfg, jnp.asarray(toks[:, t:t + 1]),
                               jcaches, jnp.int32(t), enc_out=jenc)
        _close_of_max(lg.numpy(), want[:, t:t + 1], LOGIT_RTOL,
                      f"step {t} vs teacher-forced")
        _close_of_max(lg.numpy(), jlg, LOGIT_RTOL, f"step {t} vs decode")
    caches = T.init_caches(cfg, 2, L, device="cpu")
    for t in range(L):
        nxt, caches = S.serve_step(params, cfg,
                                   torch.from_numpy(toks[:, t:t + 1]),
                                   caches, t, enc_out=enc)
        diff = nxt[:, 0].numpy() != want[:, t].argmax(-1)
        ties = ref.near_ties(-torch.tensor(want[:, t])).numpy()
        assert not (diff & ~ties).any(), t


def test_lm_loss_matches_reference(twins, encoded):
    jcfg, jp, cfg, params, _ = twins
    jenc, enc = encoded
    toks = _tokens(4, 2, 16, cfg.vocab_size)
    want = float(JT.lm_loss(jp, jcfg, jnp.asarray(toks), enc_out=jenc))
    for remat in (True, False):
        got = float(T.lm_loss(params, cfg, torch.from_numpy(toks),
                              enc_out=enc, remat=remat))
        assert abs(got - want) <= 1e-5 * abs(want), (remat, got, want)


def test_generate_and_launcher_frames(twins):
    """The launcher's frames are the reference launcher's ``jax.random
    .normal(PRNGKey(seed), (B, n_frames, d))`` bit for bit; ``generate``
    passes ``enc_out`` to every step, and the CLI runs on the CPU."""
    _, _, cfg, params, _ = twins
    for seed in (0, 1):
        shape = (2, cfg.n_audio_frames, cfg.d_model)
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
        got = serve.audio_frames(cfg, 2, seed, "cpu").numpy()
        assert got.tobytes() == want.tobytes(), seed
    prompts = torch.from_numpy(_tokens(6, 2, 4, cfg.vocab_size))
    with torch.no_grad():
        enc = T.encode_audio(params, cfg, serve.audio_frames(cfg, 2, 0, "cpu"))
    seqs = serve.generate(params, cfg, prompts, 3, enc_out=enc)
    caches = T.init_caches(cfg, 2, 7, device="cpu")
    tok = prompts[:, :1]
    for t in range(6):
        nxt, caches = S.serve_step(params, cfg, tok, caches, t, enc_out=enc)
        tok = prompts[:, t + 1:t + 2] if t + 1 < 4 else nxt
        assert torch.equal(seqs[:, t + 1:t + 2], tok.to(seqs.dtype))
    out = serve.main(["--arch", "whisper-base", "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "4", "--gen", "3"])
    assert tuple(out.shape) == (2, 7)


# ------------------------------------------------------------- refusals

def test_train_step_refuses_encoder_decoder():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        S.build_train_step(smoke_config(ARCH), TrainConfig())


@pytest.mark.parametrize("arch,mtp", [("minicpm3_4b", True),
                                      ("qwen3_0_6b", True),
                                      ("whisper_base", True)])
def test_check_supported_still_refuses_mla_and_mtp(arch, mtp):
    """MLA and the MTP head are ported: ``check_supported`` takes each of
    these configs with MTP, an encoder-decoder's too, and ``init_lm``
    draws its ``mtp`` head (``proj`` (2d, d), a block, a norm)."""
    cfg = jsmoke_config(arch).replace(use_mtp=mtp)
    T.check_supported(cfg)
    params = T.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert set(params["mtp"]) == {"proj", "block", "norm"}
    assert params["mtp"]["proj"].shape == (2 * cfg.d_model, cfg.d_model)


def test_encode_audio_needs_an_encoder():
    cfg = smoke_config("qwen3_0_6b")
    with pytest.raises(ValueError, match="no encoder"):
        T.encode_audio({}, cfg, torch.zeros(1, 4, cfg.d_model))


# ------------------------------------------- the flash kernel at Tq != Tk

def _qkv(seed, B, Tq, Tk, hq, hkv, d):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, Tq, hq, d)).astype(np.float32),
            r.standard_normal((B, Tk, hkv, d)).astype(np.float32),
            r.standard_normal((B, Tk, hkv, d)).astype(np.float32))


def _reference_attend(q, k, v):
    """The reference's non-causal attention core (k and v repeated)."""
    rep = q.shape[2] // k.shape[2]
    k, v = (np.repeat(t, rep, axis=2) for t in (k, v))
    return np.asarray(jattn._attend_full(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
        q_offset=0, window=0))


@pytest.mark.parametrize("shape", [(2, 7, 100, 4, 4, 64),
                                   (1, 70, 33, 2, 2, 64),
                                   (1, 13, 65, 8, 2, 128)])
def test_tf32_tiles_at_unequal_lengths(shape):
    """The kernel's arithmetic (CPU model: 32-key tiles, TF32 three-pass
    products) with Tk not a multiple of the tile, Tq > Tk and GQA at D
    128, against the plain version and the reference's core."""
    B, Tq, Tk, hq, hkv, d = shape
    q, k, v = _qkv(sum(shape), *shape)
    want = _reference_attend(q, k, v)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    plain = ref.flash_attention_ref(tq, tk, tv, causal=False)
    tiles = tiled_attention(tq, tk, tv, mm_tf32x3, causal=False, window=0)
    np.testing.assert_allclose(plain.numpy(), want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tiles.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.cuda
def test_cuda_flash_at_unequal_lengths():
    """On a card: the kernel at whisper-smoke's cross shape and a ragged
    Tq > Tk, against its plain version within 2e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    for shape in ((2, 24, 64, 4, 4, 64), (1, 70, 33, 8, 2, 128)):
        q, k, v = (torch.from_numpy(a) for a in _qkv(0, *shape))
        got = flash_attention_cuda(q.cuda(), k.cuda(), v.cuda(),
                                   causal=False)
        want = ref.flash_attention_ref(q, k, v, causal=False)
        assert float((got.cpu() - want).abs().max()) <= TOL
