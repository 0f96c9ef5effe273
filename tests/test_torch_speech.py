"""The speech scenario on the port against the JAX reference.

The port draws its clips from a ``torch.Generator`` and the reference from
``jax.random``, so the clips are compared on shared draws: the reference's
own draws go through the port's assembly. The phoneme bank, the conv
classifier and the GSVQ uplink are held to the reference on shared arrays
and weights; ``octopus_speech.run`` is held to behaviour. Tolerances: the
bank and the clips within 1e-6 (float32 ``exp``/``sin`` of two libraries),
the conv classifier within 1e-5 (convolutions summed in another order),
GSVQ codes bit-exact but at near ties, decoded features within 1e-6 (group
means summed in another order).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.npz import save_pytree  # noqa: E402
from repro.core import downstream as JDS  # noqa: E402
from repro.core.disentangle import perturb_private as j_perturb  # noqa: E402
from repro.core.dvqae import DVQAEConfig as JConfig  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.wire.session import OctopusServer as JServer  # noqa: E402
from repro_torch.convert import (conv_classifier_from_numpy,  # noqa: E402
                                 load_npz)
from repro_torch.core import octopus as OC  # noqa: E402
from repro_torch.core.disentangle import (perturb_private,  # noqa: E402
                                          replace_private)
from repro_torch.core.downstream import (ConvClassifier, accuracy,  # noqa: E402
                                         sgd_train, xent_loss)
from repro_torch.core.dvqae import DVQAEConfig  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.octopus_speech import run  # noqa: E402
from repro_torch.wire.session import OctopusServer  # noqa: E402

SPEECH = dict(kind="speech", in_channels=16, hidden=16, latent_dim=8,
              codebook_size=32, n_res_blocks=1, n_groups=8, n_slices=2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU tensors run far faster on one thread than on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat(tree, prefix=""):
    """A reference parameter tree -> path-keyed numpy arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


# ------------------------------------------------------------------- data

@pytest.mark.parametrize("channels", [16, 13, 40])
def test_phoneme_bank_matches_reference(channels):
    got = synthetic._phoneme_bank(channels)
    assert got.shape == (synthetic.N_PHONEMES, channels) == (16, channels)
    assert synthetic.N_PHONEMES == jsyn.N_PHONEMES
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jsyn._phoneme_bank(channels)),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,frames,channels,speakers,per_clip",
                         [(12, 64, 16, 8, 4), (5, 24, 10, 3, 3)])
def test_speech_assembly_matches_reference_on_its_draws(n, frames, channels,
                                                        speakers, per_clip):
    key = jax.random.PRNGKey(n)
    want = jsyn.make_speech(key, n, frames=frames, channels=channels,
                            n_speakers=speakers,
                            phonemes_per_clip=per_clip)
    # the reference's own draws, in its order
    kp, ks, kg, kb, kn = jax.random.split(key, 5)
    draws = (jax.random.randint(kp, (n, per_clip), 0, jsyn.N_PHONEMES),
             jax.random.randint(ks, (n,), 0, speakers),
             0.5 + jax.random.uniform(kg, (speakers, channels)),
             0.3 * jax.random.normal(kb, (speakers, channels)),
             0.05 * jax.random.normal(kn, (n, frames, channels)))
    got = synthetic.assemble_speech(
        *(torch.from_numpy(np.array(d)) for d in draws), frames=frames)
    assert got.x.shape == tuple(want.x.shape) == (n, frames, channels)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(got.content.numpy(),
                                  np.asarray(want.content))
    np.testing.assert_array_equal(got.style.numpy(), np.asarray(want.style))


def test_make_speech_draws_from_its_generator():
    a = synthetic.make_speech(torch.Generator().manual_seed(3), 9,
                              n_speakers=4)
    b = synthetic.make_speech(torch.Generator().manual_seed(3), 9,
                              n_speakers=4)
    c = synthetic.make_speech(torch.Generator().manual_seed(4), 9,
                              n_speakers=4)
    assert a.x.shape == (9, 64, 16) and a.x.dtype == torch.float32
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(a.x, c.x)
    assert int(a.content.max()) < synthetic.N_PHONEMES
    assert int(a.style.max()) < 4 and int(a.style.min()) >= 0


# ------------------------------------------------------ style transforms

def test_perturb_private_with_shared_noise(monkeypatch):
    rng = np.random.default_rng(0)
    private = rng.standard_normal((3, 1, 8)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    noise = np.array(jax.random.normal(key, private.shape, jnp.float32))
    want = np.asarray(j_perturb(key, jnp.asarray(private), scale=0.7))
    real = torch.randn

    def shared(shape, *, generator, dtype, device):
        assert tuple(shape) == private.shape and dtype == torch.float32
        real(shape, generator=generator, dtype=dtype, device=device)
        return torch.from_numpy(noise)

    monkeypatch.setattr(torch, "randn", shared)
    got = perturb_private(torch.Generator().manual_seed(0),
                          torch.from_numpy(private), scale=0.7)
    monkeypatch.undo()
    np.testing.assert_array_equal(got.numpy(), want)
    g1, g2 = (torch.Generator().manual_seed(1) for _ in range(2))
    p = torch.from_numpy(private)
    assert torch.equal(perturb_private(g1, p), perturb_private(g2, p))
    assert not torch.equal(perturb_private(g1, p), p)


def test_replace_private_is_the_identity():
    p = torch.randn(2, 1, 4)
    assert replace_private(p) is p


# ----------------------------------------------------------- conv baseline

@pytest.mark.parametrize("kind,shape", [("image", (5, 16, 12, 3)),
                                        ("speech", (5, 33, 16))])
def test_conv_classifier_matches_reference(kind, shape):
    key = jax.random.PRNGKey(2)
    params = JDS.init_conv_classifier(key, in_channels=shape[-1],
                                      n_classes=7, hidden=8, kind=kind)
    # non-zero biases, so their layout is checked too
    rng = np.random.default_rng(1)
    arrays = {k: (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
              if k.endswith("bias") or k in ("b", "hb") else v
              for k, v in flat(params).items()}
    x = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(JDS.conv_classifier(
        jax.tree.map(jnp.asarray, _nest(arrays)), jnp.asarray(x), kind=kind))
    model = conv_classifier_from_numpy(arrays, kind=kind, device="cpu")
    assert isinstance(model, ConvClassifier) and model.kind == kind
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (5, 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def _nest(arrays):
    out = {}
    for k, v in arrays.items():
        *path, leaf = k.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


@pytest.mark.parametrize("kind", ["image", "speech"])
def test_sgd_train_and_accuracy_take_the_conv_classifier(kind):
    g = torch.Generator().manual_seed(0)
    if kind == "image":
        data = synthetic.make_images(g, 64, size=8, n_identities=3)
        cin = 3
    else:
        data = synthetic.make_speech(g, 64, frames=16, n_speakers=3)
        cin = 16
    model = ConvClassifier(cin, 16, hidden=8, kind=kind, generator=g)
    with torch.no_grad():
        before = float(xent_loss(model, data.x, data.content))
    assert sgd_train(g, model, data.x, data.content, steps=40,
                     lr=3e-3) is model
    with torch.no_grad():
        after = float(xent_loss(model, data.x, data.content))
    assert after < before
    assert 0.0 <= accuracy(model, data.x, data.content) <= 1.0


def test_conv_classifier_refuses_other_kinds():
    with pytest.raises(ValueError, match="image or speech"):
        ConvClassifier(3, 2, kind="sequence")


# ------------------------------------------------------------- GSVQ uplink

def test_gsvq_speech_transmit_and_features_match_reference(tmp_path):
    jcfg, cfg = JConfig(**SPEECH), DVQAEConfig(**SPEECH)
    jsrv = JServer.init(jax.random.PRNGKey(0), jcfg)
    path = str(tmp_path / "params.npz")
    save_pytree(path, jsrv.state.params)
    srv = OctopusServer(OC.ServerState(params=load_npz(path, cfg,
                                                       device="cpu")),
                        cfg, device="cpu")
    clips = jsyn.make_speech(jax.random.PRNGKey(1), 24, n_speakers=4)
    x = np.array(clips.x)
    jp = JServer.deploy(jsrv).transmit(jnp.asarray(x),
                                       labels=clips.content)
    tp = srv.deploy().transmit(x, labels=torch.from_numpy(
        np.array(clips.content)))
    assert tp.bits == jp.bits == 3 and tp.shape == tuple(jp.shape) \
        == (1, 24, 16, 2)
    G, W = 32, 3                     # 3-bit codes: 32 codes in 3 words
    assert tp.nbytes == jp.nbytes == math.ceil(24 * 16 * 2 / G) * W * 4
    z, _ = OC.client_encode(srv.state.params, cfg, torch.from_numpy(x))
    scores = ref.encode_scores(z.reshape(1, -1, cfg.latent_dim),
                               srv.registry.current[None], n_groups=8,
                               n_slices=2)
    jcodes = torch.from_numpy(np.array(jp.unpack()).reshape(-1))
    n_diff, n_out = ref.code_mismatches(tp.unpack().reshape(-1), jcodes,
                                        scores)
    assert n_out == 0 and n_diff <= 1e-3 * jcodes.numel()
    if n_diff == 0:
        np.testing.assert_array_equal(tp.payload.numpy().view(np.uint32),
                                      np.asarray(jp.payload))
    srv.ingest(tp)
    jsrv.ingest(jp)
    feats, labels = srv.features()
    jfeats, jlabels = jsrv.features()
    assert feats.shape == tuple(jfeats.shape) == (24, 16, cfg.latent_dim)
    np.testing.assert_array_equal(labels["label"].numpy(),
                                  np.asarray(jlabels["label"]))
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(srv.decode(tp).numpy(), feats.numpy())


# ------------------------------------------------------ octopus_speech.run

def test_speech_run_on_the_cpu():
    cfg = DVQAEConfig(**SPEECH)
    res = run(cfg, device="cpu", n_clips=120, pretrain_steps=50,
              probe_steps=20, audit_steps=20)
    losses = res["recon_losses"]
    assert len(losses) == 50 and all(math.isfinite(v) for v in losses)
    assert np.mean(losses[-20:]) < np.mean(losses[:20])
    assert res["n_train"] == 96 and res["n_test"] == 24
    assert res["payload_shape"] == (1, 96, 16, 2)
    assert res["uplink_bytes"] == math.ceil(96 * 16 * 2 / 32) * 3 * 4
    assert res["anon_shape"] == (4, 64, 16)
    for k in ("phoneme_accuracy", "reid_accuracy", "reid_entropy_bits",
              "anon_distortion"):
        assert math.isfinite(res[k]), k
    assert len(res["server"].store) == 1


def test_speech_entry_points_need_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run(DVQAEConfig(**SPEECH), n_clips=10, pretrain_steps=0)
    arrays = flat(JDS.init_conv_classifier(jax.random.PRNGKey(0),
                                           in_channels=3, n_classes=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        conv_classifier_from_numpy(arrays)
