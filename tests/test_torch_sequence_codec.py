"""Port parity of the DVQ-AE ``sequence`` kind: the linear codec (d_model
-> M projection, no bias) that the privacy red team attacks.

The reference's weights (``repro.privacy.sweep.make_codec``, drawn with
``jax.random``) cross into the port through ``convert.params_from_numpy``;
both packages see the same numpy batches. Floats within 1e-5*(1+|ref|);
transmitted words bit for bit (codes may differ only at near ties of the
reference's scores)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import dvqae as JD  # noqa: E402
from repro.privacy import sweep as JSW  # noqa: E402
from repro_torch.convert import (init_numpy_params,  # noqa: E402
                                 params_from_numpy, params_to_numpy)
from repro_torch.core import dvqae as D  # noqa: E402
from repro_torch.core import octopus as OC  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.optim.adamw import adamw_init  # noqa: E402
from repro_torch.wire.session import OctopusServer  # noqa: E402

torch.set_num_threads(1)

D_MODEL, M, T = 12, 8, 10
#: (K, n_groups, n_slices): the sweep's codebook sizes and GSVQ groupings
CODECS = [(16, 1, 1), (32, 1, 1), (64, 1, 1), (256, 1, 1), (32, 2, 1),
          (32, 4, 1), (32, 4, 2)]


def flat_params(params) -> dict:
    return {"encoder/proj": np.array(params["encoder"]["proj"]),
            "decoder/proj": np.array(params["decoder"]["proj"]),
            "codebook": np.array(params["codebook"])}


def close(got, want, what):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want)
    assert (err <= 1e-5 * (1 + np.abs(want))).all(), \
        f"{what}: max err {err.max()}"


def batch(seed=0, n=16):
    return np.random.default_rng(seed).normal(
        size=(n, T, D_MODEL)).astype(np.float32) * 2.0


def ref_codec(K, G, S, apply_in):
    """(reference cfg, params, server) and the port's on the same weights."""
    jcfg, jparams, jsrv = JSW.make_codec(0, K=K, apply_in=apply_in,
                                         n_groups=G, n_slices=S)
    cfg = D.DVQAEConfig(kind="sequence", latent_dim=M, codebook_size=K,
                        apply_in=apply_in, n_groups=G, n_slices=S)
    params = params_from_numpy(flat_params(jparams), cfg, device="cpu")
    srv = OctopusServer(OC.ServerState(params=params,
                                       opt=adamw_init(OC.trainable(params))),
                        cfg, device="cpu")
    return jcfg, jparams, jsrv, cfg, params, srv


def test_modules_layout_and_d_model():
    cfg = D.DVQAEConfig(kind="sequence", latent_dim=M, codebook_size=32)
    enc = D.make_encoder(cfg, d_model=D_MODEL)
    dec = D.make_decoder(cfg, d_model=D_MODEL)
    assert [(n, tuple(p.shape)) for n, p in enc.named_parameters()] == \
        [("proj", (D_MODEL, M))]
    assert [(n, tuple(p.shape)) for n, p in dec.named_parameters()] == \
        [("proj", (M, D_MODEL))]
    with pytest.raises(ValueError, match="d_model"):
        D.make_encoder(cfg)
    with pytest.raises(ValueError, match="kind"):
        D.make_decoder(cfg.replace(kind="video"))


def test_convert_both_ways_and_init_scales():
    _, jparams, _ = JSW.make_codec(3, K=64)
    flat = flat_params(jparams)
    cfg = D.DVQAEConfig(kind="sequence", latent_dim=M, codebook_size=64)
    back = params_to_numpy(params_from_numpy(flat, cfg, device="cpu"))
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    drawn = init_numpy_params(cfg, 0, d_model=D_MODEL)
    assert {k: v.shape for k, v in drawn.items()} == \
        {k: v.shape for k, v in flat.items()}
    # dense_init's U(+-1/sqrt(d_in)), the reference's scale
    assert np.abs(drawn["encoder/proj"]).max() <= 1 / np.sqrt(D_MODEL)
    assert np.abs(drawn["decoder/proj"]).max() <= 1 / np.sqrt(M)
    assert drawn["encoder/proj"].std() > 0.5 / np.sqrt(3 * D_MODEL)


@pytest.mark.parametrize("K,G,S", [(32, 1, 1), (32, 4, 2)])
@pytest.mark.parametrize("apply_in", [True, False])
def test_encode_decode_forward_match_reference(K, G, S, apply_in):
    jcfg, jparams, _, cfg, params, _ = ref_codec(K, G, S, apply_in)
    x = batch(1)
    jz, jsp = JD.encode(jparams, jcfg, jnp.asarray(x))
    z, sp = D.encode(params, cfg, torch.from_numpy(x))
    assert sp is None and jsp is None
    close(z, jz, "encode")
    close(D.decode(params, cfg, z), JD.decode(jparams, jcfg, jz), "decode")
    jout = JD.forward(jparams, jcfg, jnp.asarray(x))
    out = D.forward(params, cfg, torch.from_numpy(x))
    close(out.recon, jout.recon, "recon")
    close(out.loss, jout.loss, "loss")
    close(out.recon_loss, jout.recon_loss, "recon_loss")
    np.testing.assert_array_equal(out.latent.indices.numpy(),
                                  np.asarray(jout.latent.indices))


@pytest.mark.parametrize("K,G,S", CODECS)
@pytest.mark.parametrize("apply_in", [True, False])
def test_transmit_words_match_reference(K, G, S, apply_in):
    """``srv.deploy().transmit(x)``: the port's one encode_codes dispatch
    against the reference's fused wire, on the same weights and batch."""
    jcfg, jparams, jsrv, cfg, params, srv = ref_codec(K, G, S, apply_in)
    x = batch(K + G + S)
    jp = jsrv.deploy().transmit(jnp.asarray(x))
    p = srv.deploy().transmit(x)
    assert (p.bits, p.shape, p.n_records, p.nbytes) == \
        (jp.bits, jp.shape, jp.n_records, jp.nbytes)
    assert p.bits == OC.transmit_bits(cfg)
    words = p.payload.numpy().view(np.uint32)
    jwords = np.asarray(jp.payload)
    if not np.array_equal(words, jwords):
        # codes may differ only where the reference's scores nearly tie
        z, _ = OC.client_encode(params, cfg, torch.from_numpy(x))
        scores = ref.encode_scores(z.reshape(1, -1, M),
                                   params["codebook"][None],
                                   n_groups=G, n_slices=S)
        codes = p.unpack().reshape(1, -1)
        jcodes = torch.from_numpy(np.asarray(jp.unpack()).reshape(1, -1))
        n_diff, n_out = ref.code_mismatches(codes, jcodes, scores)
        assert n_out == 0, f"{n_diff} codes differ, {n_out} not at ties"


def test_server_init_draws_a_sequence_codec():
    cfg = D.DVQAEConfig(kind="sequence", latent_dim=M, codebook_size=16)
    srv = OctopusServer.init(0, cfg, device="cpu", d_model=D_MODEL)
    assert tuple(srv.state.params["encoder"].proj.shape) == (D_MODEL, M)
    assert len(srv.state.opt.mu) == 3          # two projections + codebook
    p = srv.deploy().transmit(batch(2, 4))
    assert p.shape == (1, 4, T) and p.bits == 4
