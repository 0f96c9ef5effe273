"""The port's serving slice end to end on the CPU, against the JAX package.

A reference ``OctopusServer.init``; its parameters through
``save_pytree`` and ``convert.load_npz`` into the port; two clients
transmit the same images through both packages; both servers ingest and
decode; a linear probe from the reference's init scores the features.

Codes follow the near-tie rule; features equal the reference's bit for
bit wherever the codes agree; logits atol 1e-4.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.npz import save_pytree  # noqa: E402
from repro.core import octopus as JOC  # noqa: E402
from repro.core.downstream import init_linear_probe, linear_probe  # noqa: E402
from repro.core.dvqae import DVQAEConfig as JConfig  # noqa: E402
from repro.wire.session import OctopusServer as JServer  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.convert import load_npz, probe_from_numpy  # noqa: E402
from repro_torch.core import octopus as OC  # noqa: E402
from repro_torch.core.downstream import accuracy  # noqa: E402
from repro_torch.core.dvqae import DVQAEConfig  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.wire.session import OctopusServer  # noqa: E402

SMALL = dict(hidden=32, latent_dim=16, codebook_size=32, n_res_blocks=1)
SRC = Path(__file__).resolve().parents[1] / "src"


def scores64(z, cb):
    """The reference's VQ score ``||e||^2 - 2 z.e`` in float64."""
    z, cb = np.asarray(z, np.float64), np.asarray(cb, np.float64)
    return (cb * cb).sum(-1)[None, :] - 2 * z.reshape(-1, z.shape[-1]) @ cb.T


@pytest.fixture()
def twins(tmp_path):
    jcfg, cfg = JConfig(**SMALL), DVQAEConfig(**SMALL)
    jsrv = JServer.init(jax.random.PRNGKey(0), jcfg)
    path = str(tmp_path / "params.npz")
    save_pytree(path, jsrv.state.params)
    srv = OctopusServer(OC.ServerState(params=load_npz(path, cfg,
                                                       device="cpu")), cfg,
                        device="cpu")
    return jsrv, srv, jcfg, cfg


def test_slice_matches_reference(twins, tmp_path):
    jsrv, srv, jcfg, cfg = twins
    rng = np.random.default_rng(0)
    x = rng.random((2, 4, 16, 16, 3), dtype=np.float32)
    y = rng.integers(0, 3, (2, 4))
    ops.reset_launches()
    for i in range(2):
        jp = jsrv.deploy(client_id=i).transmit(jnp.asarray(x[i]),
                                               labels=y[i])
        tp = srv.deploy(client_id=i).transmit(x[i], labels=y[i])
        assert (tp.shape, tp.bits, tp.nbytes) == (jp.shape, jp.bits,
                                                   jp.nbytes)
        jz, _ = JOC.client_encode(jsrv.state.params, jcfg, jnp.asarray(x[i]))
        sc = torch.from_numpy(scores64(jz, jsrv.state.params["codebook"]))
        n_diff, n_out = ref.code_mismatches(
            tp.unpack(), torch.from_numpy(np.array(jp.unpack())), sc)
        print(f"client {i}: {n_diff} of {tp.count} codes differ")
        assert n_out == 0 and n_diff <= 1e-3 * tp.count
        if n_diff == 0:
            assert tp.checksum == jp.checksum
        assert jsrv.ingest(jp, client_ids=[i]).verdict == "accepted"
        assert srv.ingest(tp, client_ids=[i]).verdict == "accepted"
    jf, jl = jsrv.features()
    tf, tl = srv.features()
    assert tuple(tf.shape) == tuple(jf.shape) == (8, 16, 16)
    jcodes = np.concatenate([np.asarray(r.packed.unpack()).reshape(-1)
                             for r in jsrv.store.records])
    tcodes = torch.cat([r.packed.unpack().reshape(-1)
                        for r in srv.store.records]).numpy()
    same = (jcodes == tcodes).reshape(8, 16)
    np.testing.assert_array_equal(tf.numpy()[same], np.asarray(jf)[same])
    np.testing.assert_array_equal(tl["label"].numpy(),
                                  np.asarray(jl["label"]))

    probe = init_linear_probe(jax.random.PRNGKey(5), 16 * 16, 3, hidden=8)
    ppath = str(tmp_path / "probe.npz")
    save_pytree(ppath, probe)
    with np.load(ppath) as data:
        head = probe_from_numpy(dict(data), device="cpu")
    with torch.no_grad():
        logits = head(tf)
    np.testing.assert_allclose(logits.numpy(),
                               np.asarray(linear_probe(probe, jf)),
                               atol=1e-4)
    assert 0.0 <= accuracy(head, tf, tl["label"]) <= 1.0
    # decode() merges the client axis, like the reference's
    held = rng.random((3, 16, 16, 3), dtype=np.float32)
    tp = srv.deploy().transmit(held)
    assert tuple(srv.decode(tp).shape) == (3, 16, 16)
    assert all(n == 0 for n in ops.LAUNCHES.values()), ops.LAUNCHES


def test_refresh_round_matches_reference(twins):
    """round(finetune=0): the Step 5 EMA refresh from the encode's own
    statistics moves the codebook as the reference's does. (A round with
    fine-tuning is held against the reference in test_torch_train.)"""
    jsrv, srv, jcfg, cfg = twins
    x = np.random.default_rng(1).random((4, 16, 16, 3), dtype=np.float32)
    jc = jsrv.deploy()
    tc = srv.deploy()
    jp = jc.round(jnp.asarray(x), finetune=0)
    tp = tc.round(x, finetune=0)
    np.testing.assert_array_equal(tp.unpack().numpy(),
                                  np.asarray(jp.unpack()))
    np.testing.assert_allclose(tc.codebook.numpy(), np.asarray(jc.codebook),
                               rtol=1e-5, atol=1e-5)
    assert tc.state.step == 0


def test_features_decode_each_version_against_its_snapshot(twins,
                                                          monkeypatch):
    """Payloads packed under two codebook versions: features() runs ONE
    decode dispatch per version, each against its registry snapshot."""
    _, srv, _, cfg = twins
    rng = np.random.default_rng(4)
    p0 = srv.deploy().transmit(rng.random((2, 16, 16, 3), dtype=np.float32))
    cb1 = torch.from_numpy(rng.standard_normal((32, 16)).astype(np.float32))
    assert srv.registry.register(cb1) == 1 and 1 in srv.registry
    codes1 = torch.from_numpy(rng.integers(0, 32, (1, 3, 16)))
    from repro_torch.wire.payload import CodePayload
    p1 = CodePayload.pack(codes1, bits=5, version=1)
    for p in (p0, p1, p0):
        assert srv.ingest(p).verdict == "accepted"
    calls = []
    real = ops.decode_codes
    monkeypatch.setattr(ops, "decode_codes",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    feats, _ = srv.features()
    assert len(calls) == 2
    cb0 = srv.registry.get(0)
    want0 = cb0[p0.unpack().reshape(-1).long()].reshape(2, 16, 16)
    want1 = cb1[codes1.reshape(-1)].reshape(3, 16, 16)
    assert torch.equal(feats, torch.cat([want0, want1, want0]))
    v1, _ = srv.features(version=1)
    assert torch.equal(v1, want1)


def test_gsvq_bits_per_position_matches_reference():
    from repro.core.gsvq import gsvq_bits_per_position as j_bits
    from repro_torch.core.gsvq import gsvq_bits_per_position
    for g, s in [(1, 1), (1, 4), (16, 4), (5, 3), (256, 1)]:
        assert gsvq_bits_per_position(g, s) == j_bits(g, s)


def test_entry_points_need_an_explicit_cpu(twins):
    _, srv, _, cfg = twins
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OctopusServer.init(0, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OctopusServer(srv.state, cfg)
    assert srv.deploy().device == torch.device("cpu")


def test_port_imports_neither_jax_nor_reference():
    """Every module of repro_torch imports in a fresh interpreter without
    loading jax or the reference package."""
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(SRC)}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
