"""The Step 5 server merge on the port against the JAX reference.

The fixed-point path (``merge_stats``, ``merge_stats_add``,
``merge_codebook``, ``server_merge_stats``) is exact integer and IEEE
arithmetic in one order, so it must equal the reference bit for bit, for
any partition and order of the clients, and the two packages' MergeStats
must interoperate. The float merge (``server_merge_codebooks``,
``registry.merge``) sums over clients in another order than XLA: it is
held within ``1e-6 * (1 + max|cb|)``, and atoms with no weight keep the
current dictionary exactly. Inputs are numpy arrays shared by both.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.checkpoint.npz import save_pytree  # noqa: E402
from repro.core import ema as jema  # noqa: E402
from repro.core import octopus as JOC  # noqa: E402
from repro.core.dvqae import DVQAEConfig as JConfig  # noqa: E402
from repro.server.registry import CodebookRegistry as JRegistry  # noqa: E402
from repro.sim.engine import stack_clients as j_stack  # noqa: E402
from repro.wire.session import OctopusServer as JServer  # noqa: E402
from repro_torch.convert import load_npz  # noqa: E402
from repro_torch.core import ema  # noqa: E402
from repro_torch.core import octopus as OC  # noqa: E402
from repro_torch.core.dvqae import DVQAEConfig  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.server.registry import CodebookRegistry  # noqa: E402
from repro_torch.wire.session import OctopusServer  # noqa: E402

C, K, M = 7, 24, 5
FLOAT_RTOL = 1e-6          # of 1 + max|cb|, the float merge


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU tensors run far faster on one thread than on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def population(seed=0, n=C, dead=(3, 11)):
    """(n, K, M) float32 codebooks and (n, K) EMA-like counts; the atoms
    in ``dead`` have zero count in every client, atom 7 a total weight
    just above the float merge's 1e-9 threshold."""
    rng = np.random.default_rng(seed)
    cbs = (rng.standard_normal((n, K, M)) * 3).astype(np.float32)
    cts = rng.uniform(0.0, 40.0, (n, K)).astype(np.float32)
    cts[:, list(dead)] = 0.0
    cts[0, 5] = 0.0                          # dead in one client only
    cts[:, 7] = 1e-6                         # barely alive
    return cbs, cts


def t(a):
    return torch.from_numpy(np.asarray(a))


def same_stats(got: ema.MergeStats, want: jema.MergeStats):
    assert got.num.dtype == got.den.dtype == torch.int64
    np.testing.assert_array_equal(got.num.numpy(), want.num)
    np.testing.assert_array_equal(got.den.numpy(), want.den)


def j_server(cb):
    return JOC.ServerState(params={"codebook": jnp.asarray(cb)}, opt=None,
                           step=jnp.zeros((), jnp.int32))


def t_server(cb):
    return OC.ServerState(params={"codebook": t(cb).clone()})


def assert_close(got, want, scale):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert err.max() <= FLOAT_RTOL * (1 + scale), err.max()


# ------------------------------------------------------- fixed-point path

@pytest.mark.parametrize("decay", [None, 0.0, 0.5, 0.9])
def test_merge_stats_equal_reference(decay):
    cbs, cts = population(1)
    kw = {}
    if decay is not None:
        kw = dict(staleness=np.array([0, 1, 2, 3, 0, 2, 1]),
                  staleness_decay=decay)
    want = jema.merge_stats(cbs, cts, **kw)
    same_stats(ema.merge_stats(t(cbs), t(cts), **kw), want)
    if decay is not None:       # staleness as a tensor too
        kw["staleness"] = t(kw["staleness"])
        same_stats(ema.merge_stats(t(cbs), t(cts), **kw), want)


def test_merge_stats_one_client_and_default_decay():
    cbs, cts = population(2)
    same_stats(ema.merge_stats(t(cbs[3]), t(cts[3])),
               jema.merge_stats(cbs[3], cts[3]))
    st_ = np.arange(C) % 3            # merge_stats' own default decay: 0.5
    same_stats(ema.merge_stats(t(cbs), t(cts), staleness=st_),
               jema.merge_stats(cbs, cts, staleness=st_))


def test_merge_stats_zero_is_the_identity():
    cbs, cts = population(3)
    z = ema.merge_stats_zero(K, M, device="cpu")
    assert z.num.shape == (K, M) and z.den.shape == (K,)
    assert z.num.dtype == z.den.dtype == torch.int64
    s = ema.merge_stats(t(cbs), t(cts))
    for a, b in ((z, s), (s, z)):
        out = ema.merge_stats_add(a, b)
        assert torch.equal(out.num, s.num) and torch.equal(out.den, s.den)
    same_stats(z, jema.merge_stats_zero(K, M))


@settings(max_examples=30, deadline=None)
@given(order=st.permutations(list(range(C))),
       cuts=st.lists(st.integers(1, C - 1), max_size=C - 1, unique=True),
       decay=st.sampled_from([None, 0.0, 0.5, 0.9]))
def test_any_partition_and_order_folds_to_the_one_shot_totals(order, cuts,
                                                              decay):
    cbs, cts = population(4)
    staleness = np.array([0, 3, 1, 0, 2, 2, 1])
    kw = {} if decay is None else dict(staleness_decay=decay)
    one_shot = ema.merge_stats(t(cbs), t(cts), staleness=staleness, **kw)
    bounds = [0] + sorted(cuts) + [C]
    acc = ema.merge_stats_zero(K, M, device="cpu")
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        idx = list(order[lo:hi])
        acc = ema.merge_stats_add(acc, ema.merge_stats(
            t(cbs[idx]), t(cts[idx]), staleness=staleness[idx], **kw))
    assert torch.equal(acc.num, one_shot.num)
    assert torch.equal(acc.den, one_shot.den)
    same_stats(acc, jema.merge_stats(cbs, cts, staleness=staleness, **kw))


@pytest.mark.parametrize("decay", [None, 0.0, 0.5, 0.9])
def test_merge_codebook_and_server_merge_stats_equal_reference(decay):
    cbs, cts = population(5)
    cur = np.random.default_rng(9).standard_normal((K, M)).astype(np.float32)
    kw = {} if decay is None else dict(
        staleness=np.array([2, 0, 1, 3, 1, 0, 2]), staleness_decay=decay)
    js = jema.merge_stats(cbs, cts, **kw)
    ts = ema.merge_stats(t(cbs), t(cts), **kw)
    want = jema.merge_codebook(js, cur)
    got = ema.merge_codebook(ts, t(cur))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    dead = np.asarray(js.den) <= 0
    assert dead[[3, 11]].all()
    np.testing.assert_array_equal(got.numpy()[dead], cur[dead])
    srv = OC.server_merge_stats(t_server(cur), ts)
    jsrv = JOC.server_merge_stats(j_server(cur), js)
    np.testing.assert_array_equal(srv.params["codebook"].numpy(),
                                  np.asarray(jsrv.params["codebook"]))


def test_merge_stats_interoperate_both_ways():
    cbs, cts = population(6)
    cur = np.random.default_rng(10).standard_normal((K, M)).astype(np.float32)
    js = jema.merge_stats(cbs, cts, staleness=np.arange(C) % 4,
                          staleness_decay=0.9)
    ts = ema.merge_stats(t(cbs), t(cts), staleness=np.arange(C) % 4,
                         staleness_decay=0.9)
    # the reference's totals through the port, and the port's through it
    from_ref = ema.merge_codebook(ema.MergeStats(t(js.num), t(js.den)),
                                  t(cur))
    from_port = jema.merge_codebook(
        jema.MergeStats(ts.num.numpy(), ts.den.numpy()), cur)
    np.testing.assert_array_equal(from_ref.numpy(), from_port)
    np.testing.assert_array_equal(from_port, jema.merge_codebook(js, cur))
    # a fold that mixes the two packages' cohorts
    half = jema.merge_stats(cbs[:3], cts[:3])
    mixed = ema.merge_stats_add(ema.MergeStats(t(half.num), t(half.den)),
                                ema.merge_stats(t(cbs[3:]), t(cts[3:])))
    same_stats(mixed, jema.merge_stats(cbs, cts))


@pytest.mark.parametrize("form", ["stacked", "list"])
@pytest.mark.parametrize("decay", [None, 0.9])
def test_merge_entry_points_take_numpy_as_the_reference_does(form, decay):
    """The same numpy arrays, stacked or as per-client lists, through both
    packages' five Step 5 entry points; the reference's numpy MergeStats
    through the port. Totals and the fixed-point codebook bit-exact, the
    float merge within FLOAT_RTOL."""
    cbs, cts = population(14)
    cur = np.random.default_rng(15).standard_normal((K, M)).astype(np.float32)
    kw = {} if decay is None else dict(
        staleness=np.array([1, 0, 3, 2, 0, 1, 2]), staleness_decay=decay)
    cin, win = (cbs, cts) if form == "stacked" else (list(cbs), list(cts))
    js = jema.merge_stats(cin, win, **kw)
    ts = ema.merge_stats(cin, win, device="cpu", **kw)
    same_stats(ts, js)
    # the reference's numpy int64 MergeStats, alone and folded with the
    # port's, and two numpy ones
    half = jema.merge_stats(cbs[:3], cts[:3])
    rest = jema.merge_stats(cbs[3:], cts[3:])
    one_shot = jema.merge_stats(cbs, cts)
    same_stats(ema.merge_stats_add(half, ema.merge_stats(
        list(cbs[3:]), list(cts[3:]), device="cpu")), one_shot)
    same_stats(ema.merge_stats_add(half, rest, device="cpu"), one_shot)
    for cur_in, kw_dev in ((t(cur), {}), (cur, dict(device="cpu"))):
        got = ema.merge_codebook(js, cur_in, **kw_dev)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(),
                                      jema.merge_codebook(js, cur))
    np.testing.assert_array_equal(
        OC.server_merge_stats(t_server(cur), js).params["codebook"].numpy(),
        np.asarray(JOC.server_merge_stats(j_server(cur), js)
                   .params["codebook"]))
    want = np.asarray(JOC.server_merge_codebooks(
        j_server(cur), cin, win, **kw).params["codebook"])
    got = OC.server_merge_codebooks(t_server(cur), cin, win, **kw) \
        .params["codebook"]
    assert got.dtype == torch.float32
    assert_close(got.numpy(), want, np.abs(cbs).max())
    if form == "list":           # a list of tensors merges the same
        tl = OC.server_merge_codebooks(t_server(cur), [t(c) for c in cbs],
                                       [t(c) for c in cts], **kw)
        assert torch.equal(tl.params["codebook"], got)


# ------------------------------------------------------------ float merge

@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("decay", [None, 0.0, 0.5, 0.9])
def test_server_merge_codebooks_matches_reference(stacked, decay):
    cbs, cts = population(7)
    cur = np.random.default_rng(11).standard_normal((K, M)).astype(np.float32)
    kw = {}
    if decay is not None:
        kw = dict(staleness=np.array([0, 1, 2, 0, 3, 1, 2]),
                  staleness_decay=decay)
    if stacked:
        jin, tin = (jnp.asarray(cbs), jnp.asarray(cts)), (t(cbs), t(cts))
    else:
        jin = ([jnp.asarray(c) for c in cbs], [jnp.asarray(c) for c in cts])
        tin = ([t(c) for c in cbs], [t(c) for c in cts])
    jkw = dict(kw)
    if "staleness" in jkw:
        jkw["staleness"] = jnp.asarray(jkw["staleness"])
    want = np.asarray(JOC.server_merge_codebooks(
        j_server(cur), *jin, **jkw).params["codebook"])
    got = OC.server_merge_codebooks(t_server(cur), *tin, **kw) \
        .params["codebook"]
    assert got.dtype == torch.float32
    assert_close(got.numpy(), want, np.abs(cbs).max())
    w = cts if decay is None else cts * np.power(
        np.float32(decay), kw["staleness"].astype(np.float32))[:, None]
    dead = w.sum(0) <= 1e-9
    assert dead[[3, 11]].all()
    np.testing.assert_array_equal(got.numpy()[dead], cur[dead])
    if not dead[7]:             # merged, however small its weight
        assert not np.array_equal(got.numpy()[7], cur[7])


def test_staleness_weighted_merge_discounts_stale_clients():
    """The port's run of the reference's own staleness checks
    (``tests/test_server.py``)."""
    cur = np.zeros((16, 8), np.float32)
    cbs = torch.stack([torch.ones((16, 8)), 3.0 * torch.ones((16, 8))])
    cts = torch.ones((2, 16))
    even = OC.server_merge_codebooks(t_server(cur), cbs, cts)
    np.testing.assert_allclose(even.params["codebook"].numpy(), 2.0,
                               rtol=1e-6)
    m = OC.server_merge_codebooks(t_server(cur), cbs, cts,
                                  staleness=torch.tensor([0, 2]),
                                  staleness_decay=0.5)
    np.testing.assert_allclose(m.params["codebook"].numpy(),
                               (1.0 + 0.25 * 3.0) / 1.25, rtol=1e-6)
    reg = CodebookRegistry(t(cur))
    reg.register(t(cur))
    merged, v = reg.merge(t_server(cur), cbs, cts,
                          client_versions=np.array([1, 0]),
                          staleness_decay=0.0)
    assert v == 2 == reg.latest
    np.testing.assert_allclose(merged.params["codebook"].numpy(), 1.0,
                               rtol=1e-6)
    allstale = OC.server_merge_codebooks(t_server(cur + 7), cbs, cts,
                                         staleness=torch.tensor([1, 2]),
                                         staleness_decay=0.0)
    np.testing.assert_array_equal(allstale.params["codebook"].numpy(),
                                  cur + 7)


@pytest.mark.parametrize("decay", [1.0, 0.5, 0.0])
def test_registry_merge_matches_reference(decay):
    cbs, cts = population(8, n=4)
    cur = np.random.default_rng(12).standard_normal((K, M)).astype(np.float32)
    versions = np.array([2, 0, 1, 2])
    jreg, treg = JRegistry(jnp.asarray(cur)), CodebookRegistry(t(cur))
    for _ in range(2):
        jreg.register(jnp.asarray(cur))
        treg.register(t(cur))
    jm, jv = jreg.merge(j_server(cur), jnp.asarray(cbs), jnp.asarray(cts),
                        client_versions=versions, staleness_decay=decay)
    tm, tv = treg.merge(t_server(cur), t(cbs), t(cts),
                        client_versions=versions, staleness_decay=decay)
    assert tv == jv == 3 == treg.latest
    assert_close(tm.params["codebook"].numpy(),
                 np.asarray(jm.params["codebook"]), np.abs(cbs).max())
    assert torch.equal(treg.current, tm.params["codebook"])
    # the staleness it applied: latest 2 minus each version, floored at 0
    w = cts * (np.float32(decay) ** (2 - versions).astype(np.float32)
               )[:, None] if decay != 1.0 else cts
    direct = OC.server_merge_codebooks(t_server(cur), t(cbs), t(w))
    assert_close(tm.params["codebook"].numpy(),
                 direct.params["codebook"].numpy(), np.abs(cbs).max())


# ------------------------------------------------------------ EMA updates

def test_ema_update_and_batch_optimal_atoms_match_reference():
    rng = np.random.default_rng(13)
    cb = rng.standard_normal((K, M)).astype(np.float32)
    z = rng.standard_normal((3, 10, M)).astype(np.float32)
    idx = rng.integers(0, K, (3, 10)).astype(np.int32)
    jst = jema.ema_update(jema.init_ema(jnp.asarray(cb)), jnp.asarray(z),
                          jnp.asarray(idx), gamma=0.9)
    tst = ema.ema_update(ema.init_ema(t(cb)), t(z), t(idx), gamma=0.9)
    for got, want in zip(tst, jst):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    jmean, jn = jema.batch_optimal_atoms(jnp.asarray(z), jnp.asarray(idx), K)
    tmean, tn = ema.batch_optimal_atoms(t(z), t(idx), K)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), rtol=0,
                               atol=1e-6)


# -------------------------------------------------------------- session

SMALL = dict(hidden=16, latent_dim=8, codebook_size=16, n_res_blocks=1)


def test_session_merge_sync_and_per_version_decode(tmp_path):
    """deploy -> round -> merge -> sync -> transmit -> ingest ->
    features() on both packages from the same weights and batches."""
    jcfg, cfg = JConfig(**SMALL), DVQAEConfig(**SMALL)
    jsrv = JServer.init(jax.random.PRNGKey(0), jcfg)
    path = str(tmp_path / "params.npz")
    save_pytree(path, jsrv.state.params)
    srv = OctopusServer(OC.ServerState(params=load_npz(path, cfg,
                                                       device="cpu")),
                        cfg, device="cpu")
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((2, 3, 6, 16, 16, 3)).astype(np.float32)
    jcls = [jsrv.deploy(client_id=i) for i in range(3)]
    tcls = [srv.deploy(client_id=i) for i in range(3)]
    for i, (jc, tc) in enumerate(zip(jcls, tcls)):
        tp = tc.round(xs[0, i], finetune=0)
        jp = jc.round(jnp.asarray(xs[0, i]), finetune=0)
        # v0 words: bit-exact but at near ties
        z, _ = OC.client_encode(srv.state.params, cfg, t(xs[0, i]))
        z = z.reshape(1, -1, cfg.latent_dim)
        scores = ref.encode_scores(z, srv.registry.get(0)[None])
        codes = torch.from_numpy(np.array(jp.unpack()).reshape(-1))
        n_diff, n_out = ref.code_mismatches(tp.unpack().reshape(-1), codes,
                                            scores)
        assert n_out == 0
        if n_diff == 0:
            np.testing.assert_array_equal(
                tp.payload.numpy().view(np.uint32), np.asarray(jp.payload))
        srv.ingest(tp, client_ids=[i])
        jsrv.ingest(jp, client_ids=[i])
    assert srv.merge_clients(OC.stack_clients([c.state for c in tcls])) \
        == jsrv.merge_clients(j_stack([c.state for c in jcls])) == 1
    for jc, tc in zip(jcls, tcls):
        jc.sync(jsrv)
        tc.sync(srv)
        assert tc.version == jc.version == 1
        assert torch.equal(tc.codebook, srv.registry.current)
        assert tc.codebook is not srv.registry.current
        assert torch.equal(tc.state.ema.counts, torch.ones(16))
    cb1 = srv.registry.current.numpy()
    assert not np.array_equal(cb1, srv.registry.get(0).numpy())
    assert_close(cb1, np.asarray(jsrv.registry.current), np.abs(cb1).max())
    for i, (jc, tc) in enumerate(zip(jcls, tcls)):
        tp = tc.transmit(xs[1, i])
        assert tp.version == 1
        srv.ingest(tp, client_ids=[i], round=1)
        jsrv.ingest(jc.transmit(jnp.asarray(xs[1, i])), client_ids=[i],
                    round=1)
    feats, _ = srv.features()
    jfeats, _ = jsrv.features()
    assert feats.shape == tuple(jfeats.shape) == (36, 16, cfg.latent_dim)
    # each record decodes against its own snapshot
    rows = feats.reshape(6, -1, cfg.latent_dim)
    for r, rec in enumerate(srv.store.records):
        n = rows.shape[1]
        want = ref.decode_codes_ref(rec.packed.payload,
                                    srv.registry.get(rec.version),
                                    bits=rec.packed.bits, count=n)
        assert torch.equal(rows[r], want)
        jrow = np.asarray(jfeats).reshape(6, n, -1)[r]
        tcodes = rec.packed.unpack().reshape(-1)
        jcodes = np.asarray(jsrv.store.records[r].packed.unpack()) \
            .reshape(-1)
        agree = tcodes.numpy() == jcodes
        assert agree.mean() >= 0.99
        assert_close(rows[r].numpy()[agree], jrow[agree], np.abs(cb1).max())
    v1, _ = srv.features(version=1)
    assert torch.equal(v1, feats[18:])


def test_merge_entry_points_need_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ema.merge_stats_zero(K, M)
    assert ema.merge_stats_zero(K, M, device="cpu").num.device.type == "cpu"


def test_numpy_merge_inputs_go_to_the_card_unless_told():
    """Numpy inputs carry no device: merge_stats, merge_stats_add and
    merge_codebook put them on cuda unless given device="cpu" (and refuse
    without a GPU); tensors keep their own."""
    cbs, cts = population(16)
    js = jema.merge_stats(cbs, cts)
    cur = cbs[0]
    if torch.cuda.is_available():
        assert ema.merge_stats(cbs, cts).num.device.type == "cuda"
        assert ema.merge_stats_add(js, js).den.device.type == "cuda"
        assert ema.merge_codebook(js, cur).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ema.merge_stats(cbs, cts)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ema.merge_stats_add(js, js)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ema.merge_codebook(js, cur)
    assert ema.merge_stats(t(cbs), t(cts)).num.device.type == "cpu"
    assert ema.merge_stats_add(js, js, device="cpu").den.device.type == "cpu"
    assert ema.merge_codebook(js, t(cur)).device.type == "cpu"
    assert ema.merge_codebook(js, cur, device="cpu").device.type == "cpu"
