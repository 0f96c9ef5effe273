"""The port's population engine (``repro_torch.sim.engine``) and federated
iterators against the JAX package, on the CPU.

* ``partition_stacked``, ``stacked_batches`` and ``batches`` draw with
  ``numpy.random.default_rng`` as the reference does: equal index for
  index.
* ``SimEngine.round`` is a loop of the port's own per-client rounds, bit
  for bit (per-client encoder passes, one encode dispatch whose records do
  not depend on the stack, per-client EMA updates).
* Against the reference's plain-vmap ``SimEngine`` on shared numpy inputs
  and converted parameters: codes equal but at near ties (second-best
  within ``1e-3*(1+|best|)``, <= 0.1%), words equal wherever the codes
  are, EMA and merged codebooks within ``1e-5*(1+|x|)`` on the atoms whose
  codes agree, ``nbytes`` and shapes exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.npz import save_pytree  # noqa: E402
from repro.core import octopus as JOC  # noqa: E402
from repro.core.dvqae import DVQAEConfig as JConfig  # noqa: E402
from repro.data import federated as jfed  # noqa: E402
from repro.data.synthetic import LabeledData as JData  # noqa: E402
from repro.sim import SimEngine as JEngine  # noqa: E402
from repro_torch.convert import load_npz  # noqa: E402
from repro_torch.core import octopus as OC  # noqa: E402
from repro_torch.core.dvqae import DVQAEConfig  # noqa: E402
from repro_torch.data import federated as fed  # noqa: E402
from repro_torch.data.synthetic import LabeledData  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.sim import (SimEngine, client_batch_size,  # noqa: E402
                             stack_clients, unstack_clients)
from repro_torch.wire.payload import concat_payloads  # noqa: E402
from repro_torch.wire.session import OctopusServer  # noqa: E402

TINY = dict(kind="image", in_channels=3, hidden=8, latent_dim=8,
            codebook_size=16, n_res_blocks=1)
GSVQ = dict(TINY, n_groups=4, n_slices=2)
C, B = 4, 2
TOL = 1e-5                  # of 1 + |x|: EMA and merged codebooks


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU tensors run far faster on one thread than on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def labeled(n=53, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4, 4, 3)).astype(np.float32)
    content = rng.integers(0, 5, n).astype(np.int32)
    style = rng.integers(0, 3, n).astype(np.int32)
    return (JData(jnp.asarray(x), jnp.asarray(content), jnp.asarray(style)),
            LabeledData(torch.from_numpy(x), torch.from_numpy(content),
                        torch.from_numpy(style)))


def same_data(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------------------ data

@pytest.mark.parametrize("regime", ["iid", "worst", "skewed"])
def test_partition_stacked_matches_reference(regime):
    jd, td = labeled()
    want = jfed.partition_stacked(jd, 5, regime=regime, skew=0.4, seed=7)
    got = fed.partition_stacked(td, 5, regime=regime, skew=0.4, seed=7)
    assert tuple(got.x.shape) == tuple(want.x.shape) == (5, 10, 4, 4, 3)
    same_data(got, want)


def test_stacked_batches_match_reference():
    jd, td = labeled()
    js = jfed.partition_stacked(jd, 4, regime="iid")
    ts = fed.partition_stacked(td, 4, regime="iid")
    want = list(jfed.stacked_batches(js, 3, seed=5, epochs=2))
    got = list(fed.stacked_batches(ts, 3, seed=5, epochs=2))
    assert len(got) == len(want) == 2 * (13 // 3)
    for g, w in zip(got, want):
        assert tuple(g.x.shape) == (4, 3, 4, 4, 3)
        same_data(g, w)


def test_batches_match_reference():
    jd, td = labeled()
    want = list(jfed.batches(jd, 8, seed=2, epochs=3))
    got = list(fed.batches(td, 8, seed=2, epochs=3))
    assert len(got) == len(want) == 3 * (53 // 8)
    for g, w in zip(got, want):
        same_data(g, w)


# ---------------------------------------------------------------- engine

def port_server(params_path, cfg):
    return OC.ServerState(params=load_npz(params_path, cfg, device="cpu"))


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    """The reference's server for TINY and the port's from its weights."""
    jcfg, cfg = JConfig(**TINY), DVQAEConfig(**TINY)
    jserver = JOC.server_init(jax.random.PRNGKey(0), jcfg)
    path = str(tmp_path_factory.mktemp("sim") / "params.npz")
    save_pytree(path, jserver.params)
    return jserver, path, jcfg, cfg


def images(seed=1, n_clients=C):
    return np.random.default_rng(seed).standard_normal(
        (n_clients, B, 8, 8, 3)).astype(np.float32)


@pytest.mark.parametrize("n_local_steps", [0, 1])
@pytest.mark.parametrize("kw", [TINY, GSVQ], ids=["vq", "gsvq"])
def test_engine_round_is_a_loop_of_client_rounds(kw, n_local_steps,
                                                 tmp_path):
    """One engine round == C OctopusClient.round calls, bit for bit: words,
    bytes, CRC, codebooks, EMA fields and steps."""
    import jax as _jax  # the reference only draws the weights
    jcfg, cfg = JConfig(**kw), DVQAEConfig(**kw)
    path = str(tmp_path / "p.npz")
    save_pytree(path, JOC.server_init(_jax.random.PRNGKey(0), jcfg).params)
    x = images()
    engine = SimEngine(cfg, gamma=0.9, n_local_steps=n_local_steps)
    server = port_server(path, cfg)
    clients, payload = engine.round(engine.init_clients(server, C), x)
    srv = OctopusServer(port_server(path, cfg), cfg, device="cpu")
    singles, states = [], []
    for i in range(C):
        client = srv.deploy(gamma=0.9, n_local_steps=n_local_steps)
        singles.append(client.round(x[i]))
        states.append(client.state)
    cat = concat_payloads(singles)
    assert (payload.shape, payload.n_records, payload.nbytes) == (
        cat.shape, cat.n_records, cat.nbytes)
    assert torch.equal(payload.payload, cat.payload)
    assert payload.checksum == cat.checksum
    loop = stack_clients(states)
    assert torch.equal(clients.params["codebook"],
                       loop.params["codebook"])
    for got, want in zip(clients.ema, loop.ema):
        assert torch.equal(got, want)
    assert clients.step.tolist() == loop.step.tolist() == [n_local_steps] * C
    if n_local_steps:           # each client fine-tuned its own copy
        for got, want in zip(unstack_clients(clients), states):
            for a, b in zip(got.params["encoder"].parameters(),
                            want.params["encoder"].parameters()):
                assert torch.equal(a, b)
        assert all(e is not server.params["encoder"]
                   for e in clients.params["encoder"])


def test_fresh_deploys_share_the_server_modules(twins):
    _, path, _, cfg = twins
    server = port_server(path, cfg)
    shared = SimEngine(cfg, n_local_steps=0).init_clients(server, 3)
    assert shared.params["encoder"] is server.params["encoder"]
    own = SimEngine(cfg, n_local_steps=1).init_clients(server, 3)
    assert len(own.params["encoder"]) == 3
    assert client_batch_size(own) == 3
    assert shared.params["codebook"].data_ptr() \
        != server.params["codebook"].data_ptr()


def near_ties_ok(tcodes, jcodes, z, cbs):
    """Codes of C clients under the near-tie rule against each client's
    own codebook: -> (codes that differ, (C, K) atoms touched by one)."""
    touched = np.zeros(cbs.shape[:2], bool)
    n_diff = 0
    for i in range(len(cbs)):
        zi = np.asarray(z[i], np.float64).reshape(-1, cbs.shape[-1])
        cb = np.asarray(cbs[i], np.float64)
        sc = torch.from_numpy((cb * cb).sum(-1)[None, :] - 2 * zi @ cb.T)
        t, j = tcodes[i].reshape(-1), jcodes[i].reshape(-1)
        d, out = ref.code_mismatches(t, j, sc)
        assert out == 0
        n_diff += d
        bad = (t != j).numpy()
        touched[i, t.numpy()[bad]] = True
        touched[i, j.numpy()[bad]] = True
    assert n_diff <= 1e-3 * tcodes.numel()
    return n_diff, touched


def test_engine_round_matches_reference_engine(twins):
    """The port's round and merge against the reference's plain-vmap
    engine at n_local_steps = 0 (the cohort engine's fresh deploys)."""
    jserver, path, jcfg, cfg = twins
    x = images(seed=4)
    jeng = JEngine(jcfg, gamma=0.9, n_local_steps=0)
    jcl, jp = jeng.round(jeng.init_clients(jserver, C), jnp.asarray(x))
    eng = SimEngine(cfg, gamma=0.9, n_local_steps=0)
    server = port_server(path, cfg)
    tcl, tp = eng.round(eng.init_clients(server, C), x)
    assert (tp.shape, tp.bits, tp.n_records, tp.nbytes) == (
        tuple(jp.shape), jp.bits, jp.n_records, jp.nbytes)
    tcodes = tp.unpack()
    jcodes = torch.from_numpy(np.array(jp.unpack()))
    z = [np.asarray(JOC.client_encode(jserver.params, jcfg,
                                      jnp.asarray(x[i]))[0])
         for i in range(C)]
    cbs = np.repeat(np.asarray(jserver.params["codebook"])[None], C, 0)
    n_diff, touched = near_ties_ok(tcodes, jcodes, z, cbs)
    if n_diff == 0:
        np.testing.assert_array_equal(
            tp.payload.numpy(), np.asarray(jp.payload).view(np.int32))
    keep = ~touched
    for got, want in ((tcl.ema.codebook, jcl.ema.codebook),
                      (tcl.ema.counts, jcl.ema.counts),
                      (tcl.params["codebook"], jcl.params["codebook"])):
        g, w = got.numpy()[keep], np.asarray(want)[keep]
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    merged = eng.merge_into_server(server, tcl).params["codebook"].numpy()
    jmerged = np.asarray(jeng.merge_into_server(jserver, jcl)
                         .params["codebook"])
    live = ~touched.any(0)
    np.testing.assert_allclose(merged[live], jmerged[live], rtol=TOL,
                               atol=TOL)
    # Step 6: the fused decode of the round against the current codebook
    feats = eng.dequantize(server, tp)
    jfeats = np.asarray(jeng.dequantize(jserver, jp))
    assert tuple(feats.shape) == jfeats.shape == (C * B, 4, 8)
    same = (tcodes == jcodes).reshape(C * B, 4).numpy()
    np.testing.assert_array_equal(feats.numpy()[same], jfeats[same])


def test_engine_labels_and_versions_ride_the_payload(twins):
    _, path, _, cfg = twins
    eng = SimEngine(cfg, n_local_steps=0)
    server = port_server(path, cfg)
    y = np.arange(C * B).reshape(C, B)
    _, p = eng.round(eng.init_clients(server, C), images(), version=3,
                     labels={"content": y})
    assert p.version == 3 and p.privatized and p.verify()
    assert p.labels["content"].tolist() == list(range(C * B))
    with pytest.raises(ValueError, match="client batches"):
        eng.round(eng.init_clients(server, C - 1), images())


def test_unported_parts_raise(twins):
    """The removed carriers raise; a sharded engine (``mesh=``, ported:
    tests/test_torch_moe_ep.py) refuses a cohort its data axes do not
    divide before it touches a process group."""
    from repro_torch.launch.mesh import abstract_mesh
    _, path, _, cfg = twins
    eng = SimEngine(cfg, n_local_steps=0,
                    mesh=abstract_mesh((2, 1), ("data", "model")))
    server = port_server(path, cfg)
    with pytest.raises(ValueError, match="do not split over 2 data"):
        eng.round(eng.init_clients(server, 3), images(n_clients=3))
    import repro_torch.sim as sim
    import repro_torch.sim.engine as engine_mod
    for name in ("IngestBuffer", "PackedCodes"):
        with pytest.raises(ImportError, match="removed"):
            getattr(sim, name)
    with pytest.raises(ImportError, match="removed"):
        engine_mod.PackedCodes
