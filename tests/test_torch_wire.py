"""Port parity on the wire: payloads packed by the port carry the same
words, nbytes and CRC as the reference's, cross between the two packages
in both directions, and get the same admission verdicts."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.npz import save_pytree  # noqa: E402
from repro.core.dvqae import DVQAEConfig as JConfig  # noqa: E402
from repro.wire.payload import CodePayload as JPayload  # noqa: E402
from repro.wire.payload import concat_payloads as j_concat  # noqa: E402
from repro.wire.session import OctopusServer as JServer  # noqa: E402
from repro_torch.convert import load_npz  # noqa: E402
from repro_torch.core import octopus as OC  # noqa: E402
from repro_torch.core.dvqae import DVQAEConfig  # noqa: E402
from repro_torch.wire.payload import (SUPPORTED_WIRE_VERSIONS,  # noqa: E402
                                      WIRE_VERSION, CodePayload,
                                      concat_payloads, payload_crc)
from repro_torch.wire.session import OctopusServer  # noqa: E402

SMALL = dict(hidden=16, latent_dim=8, codebook_size=16, n_res_blocks=1)


def to_ref(p: CodePayload) -> JPayload:
    """Port carrier -> reference carrier, bytes and metadata unchanged."""
    labels = None if p.labels is None else {
        t: jnp.asarray(v.cpu().numpy()) for t, v in p.labels.items()}
    return JPayload(payload=jnp.asarray(p.payload.cpu().numpy()
                                        .view(np.uint32)),
                    bits=p.bits, shape=p.shape, n_records=p.n_records,
                    version=p.version, labels=labels,
                    privatized=p.privatized, wire=p.wire,
                    checksum=p.checksum)


def from_ref(p: JPayload) -> CodePayload:
    """Reference carrier -> port carrier, bytes and metadata unchanged."""
    labels = None if p.labels is None else {
        t: torch.from_numpy(np.array(v)) for t, v in p.labels.items()}
    return CodePayload(payload=torch.from_numpy(
        np.array(p.payload).view(np.int32)), bits=p.bits, shape=p.shape,
        n_records=p.n_records, version=p.version, labels=labels,
        privatized=p.privatized, wire=p.wire, checksum=p.checksum)


def twin_servers(tmp_path, **over):
    """A reference server and a port server (CPU) on the same weights."""
    jcfg, cfg = JConfig(**SMALL, **over), DVQAEConfig(**SMALL, **over)
    jsrv = JServer.init(jax.random.PRNGKey(0), jcfg)
    path = str(tmp_path / "params.npz")
    save_pytree(path, jsrv.state.params)
    srv = OctopusServer(OC.ServerState(params=load_npz(path, cfg,
                                                       device="cpu")), cfg,
                        device="cpu")
    return jsrv, srv


def test_wire_constants_match_reference():
    from repro.wire import payload as jp
    assert WIRE_VERSION == jp.WIRE_VERSION == 2
    assert SUPPORTED_WIRE_VERSIONS == jp.SUPPORTED_WIRE_VERSIONS == (1, 2)


@pytest.mark.parametrize("bits", [1, 3, 8, 12])
def test_pack_words_nbytes_crc_match_reference(bits):
    """Through the reference's own pack (its Pallas kernel, interpreted)."""
    rng = np.random.default_rng(bits)
    idx = rng.integers(0, 1 << bits, (1, 4, 6)).astype(np.int32)
    jp = JPayload.pack(jnp.asarray(idx), bits=bits, version=3)
    tp = CodePayload.pack(torch.from_numpy(idx), bits=bits, version=3)
    np.testing.assert_array_equal(tp.payload.numpy().view(np.uint32),
                                  np.asarray(jp.payload))
    assert (tp.nbytes, tp.checksum, tp.shape) == (jp.nbytes, jp.checksum,
                                                   jp.shape)
    assert tp.checksum == payload_crc(np.asarray(jp.payload), bits=bits,
                                      shape=jp.shape, n_records=1, version=3)


def test_pack_refuses_float_latents():
    with pytest.raises(TypeError, match="untransmittable"):
        CodePayload.pack(torch.zeros((1, 2, 3)), bits=4)


def test_concat_payloads_matches_reference():
    rng = np.random.default_rng(5)
    parts = [rng.integers(0, 32, (1, 3, 7)).astype(np.int32)
             for _ in range(3)]
    labs = [rng.integers(0, 4, 3) for _ in range(3)]
    jc = j_concat(
        [JPayload.pack_records(jnp.asarray(p), bits=5, labels=y)
         for p, y in zip(parts, labs)])
    tc = concat_payloads([CodePayload.pack_records(torch.from_numpy(p),
                                                   bits=5, labels=y)
                          for p, y in zip(parts, labs)])
    np.testing.assert_array_equal(tc.payload.numpy().view(np.uint32),
                                  np.asarray(jc.payload))
    assert (tc.shape, tc.n_records, tc.checksum) == (jc.shape, jc.n_records,
                                                     jc.checksum)
    np.testing.assert_array_equal(tc.labels["label"].numpy(),
                                  np.asarray(jc.labels["label"]))


@pytest.mark.parametrize("gsvq", [False, True], ids=["vq", "gsvq"])
def test_interop_port_to_reference(tmp_path, gsvq):
    """A port client's payload is accepted and decoded by a reference
    server, to the same features the port server decodes."""
    over = dict(n_groups=4, n_slices=2) if gsvq else {}
    jsrv, srv = twin_servers(tmp_path, **over)
    x = np.random.default_rng(1).standard_normal((3, 16, 16, 3)) \
        .astype(np.float32)
    p = srv.deploy().transmit(x, labels=np.arange(3))
    res = jsrv.ingest(to_ref(p))
    assert res.verdict == "accepted", res
    assert res.nbytes == p.nbytes
    assert srv.ingest(p).verdict == "accepted"
    jf, jl = jsrv.features()
    tf, tl = srv.features()
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6)
    if not gsvq:
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tl["label"].numpy(),
                                  np.asarray(jl["label"]))


@pytest.mark.parametrize("gsvq", [False, True], ids=["vq", "gsvq"])
def test_interop_reference_to_port(tmp_path, gsvq):
    """A reference client's payload is accepted and decoded by the port."""
    over = dict(n_groups=4, n_slices=2) if gsvq else {}
    jsrv, srv = twin_servers(tmp_path, **over)
    x = np.random.default_rng(2).standard_normal((3, 16, 16, 3)) \
        .astype(np.float32)
    jp = jsrv.deploy().transmit(jnp.asarray(x))
    p = from_ref(jp)
    res = srv.ingest(p)
    assert res.verdict == "accepted", res
    np.testing.assert_array_equal(p.unpack().numpy(), np.asarray(jp.unpack()))
    want = np.asarray(jsrv.decode(jp))
    got = srv.decode(p).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if not gsvq:
        np.testing.assert_array_equal(got, want)


def _unprivatized(p):
    return p._replace(privatized=False)


def _wire_revision(p):
    return p._replace(wire=3)


def _unknown_version(p):
    return p._replace(version=7).stamped()


def _corrupt(p):
    words = p.payload.clone()
    words[0, 0] ^= 1
    return p._replace(payload=words)


@pytest.mark.parametrize("mutate,reason", [
    (_unprivatized, "unprivatized"), (_wire_revision, "wire_revision"),
    (_unknown_version, "unknown_version"), (_corrupt, "corrupt")])
def test_precheck_verdicts_match_reference(tmp_path, mutate, reason):
    jsrv, srv = twin_servers(tmp_path)
    x = np.random.default_rng(3).standard_normal((2, 16, 16, 3)) \
        .astype(np.float32)
    bad = mutate(srv.deploy().transmit(x))
    res = srv.ingest(bad)
    assert (res.verdict, res.reason) == ("rejected", reason)
    assert res.nbytes == bad.nbytes and len(srv.store) == 0
    assert jsrv.precheck(to_ref(bad)) == ("rejected", reason)
