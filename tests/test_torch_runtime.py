"""The port's server runtime against the reference's
(``repro_torch.server.runtime``, ``.multitask``, ``sim.cohort``'s traffic,
the session's ``send`` and migrations, and the two drivers).

* ``ContinuousIngestService`` given the same offers in both packages:
  identical verdicts, reasons, ``verdict_bytes``, ``TickStats``, byte
  ledgers, decode dispatches and stored provenance; wire violations are
  rejected at the door; ``(client_id, seq)`` duplicates are caught;
  ``RetryPolicy.backoff`` matches; migrations under keep, retire and
  reencode give the same ``migration_progress`` and codes (re-encoded
  codes under the near-tie rule).
* ``AsyncCodeServer``: full participation equals the engine's round; under
  churn the reference's events, versions and byte accounting, codes under
  the near-tie rule.
* ``CohortEngine.run_traffic`` / ``run_continuous`` replay bit for bit and
  match the reference's ledgers and verdicts; a port trace of a continuous
  run passes the reference's ``repro.obs.report --check``.
* ``MultiTaskTrainer``: one step from shared heads and batch within 1e-5
  of the reference; one task is ``sgd_train`` exactly.
* The drivers ``launch/octopus_server`` and ``octopus_async`` run on the
  CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro import server as JSV  # noqa: E402
from repro.checkpoint.npz import save_pytree  # noqa: E402
from repro.core import octopus as JOC  # noqa: E402
from repro.core.dvqae import DVQAEConfig as JConfig  # noqa: E402
from repro.obs import report as jreport  # noqa: E402
from repro.sim import CohortEngine as JCohort  # noqa: E402
from repro.sim import SimEngine as JEngine  # noqa: E402
from repro.wire import session as JW  # noqa: E402
from repro.wire.payload import CodePayload as JPayload  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch import server as SV  # noqa: E402
from repro_torch.convert import load_npz, probe_from_numpy  # noqa: E402
from repro_torch.core import downstream as DS  # noqa: E402
from repro_torch.core import octopus as OC  # noqa: E402
from repro_torch.core.dvqae import DVQAEConfig  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.sim import CohortEngine, SimEngine  # noqa: E402
from repro_torch.wire import session as W  # noqa: E402
from repro_torch.wire.payload import CodePayload  # noqa: E402

TINY = dict(kind="image", in_channels=3, hidden=8, latent_dim=8,
            codebook_size=16, n_res_blocks=1)
BITS = 4


@pytest.fixture(autouse=True)
def no_ambient_recorder():
    obs.uninstall()
    jobs.uninstall()
    yield
    obs.uninstall()
    jobs.uninstall()


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    """The reference's TINY server and the path of its weights."""
    jcfg = JConfig(**TINY)
    jserver = JOC.server_init(jax.random.PRNGKey(0), jcfg)
    path = str(tmp_path_factory.mktemp("rt") / "params.npz")
    save_pytree(path, jserver.params)
    return jserver, path


def port_server(path):
    cfg = DVQAEConfig(**TINY)
    return OC.ServerState(params=load_npz(path, cfg, device="cpu")), cfg


def wires(twins, **store_kw):
    """A reference and a port OctopusServer on the same weights, with
    (optionally sharded) stores."""
    jserver, path = twins
    server, cfg = port_server(path)
    jcfg = JConfig(**TINY)
    if store_kw:
        store = SV.ShardedCodeStore(cfg, **store_kw)
        jstore = JSV.ShardedCodeStore(jcfg, **store_kw)
    else:
        store, jstore = None, None
    return (W.OctopusServer(server, cfg, store=store, device="cpu"),
            JW.OctopusServer(jserver, jcfg, store=jstore))


CODEBOOKS = np.random.default_rng(9).standard_normal((3, 16, 8)) \
    .astype(np.float32)


def register(wire, jwire, n):
    for cb in CODEBOOKS[:n]:
        assert wire.registry.register(torch.from_numpy(cb)) == \
            jwire.registry.register(jnp.asarray(cb))


def payloads(codes, version, *, mutate=None):
    """The same numpy codes packed by both packages, optionally broken the
    same way (a wire violation the door must reject)."""
    p = CodePayload.pack(torch.from_numpy(codes), bits=BITS, version=version)
    jp = JPayload.pack(jnp.asarray(codes), bits=BITS, version=version)
    if mutate == "unprivatized":
        p, jp = p._replace(privatized=False), jp._replace(privatized=False)
    elif mutate == "wire":
        p, jp = p._replace(wire=9), jp._replace(wire=9)
    elif mutate == "corrupt":
        p, jp = (p._replace(checksum=(p.checksum + 1) & 0xFFFFFFFF),
                 jp._replace(checksum=(jp.checksum + 1) & 0xFFFFFFFF))
    elif mutate == "short":
        p, jp = p._replace(payload=p.payload[:0]), \
            jp._replace(payload=jp.payload[:0])
    return p, jp


def offers(seed=0, n=30):
    """A seeded offer plan: codes, version, fate, envelope, violation."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        C = int(rng.integers(1, 3))
        codes = rng.integers(0, 16, size=(C, 2, 4)).astype(np.int32)
        ids = rng.integers(0, 32, size=C)
        mutate = rng.choice([None] * 7 + ["unprivatized", "wire", "corrupt",
                                          "short"])
        version = int(rng.choice([0, 0, 0, 1, 2, 5]))
        uid = None if rng.random() < 0.3 else \
            (int(ids[0]), int(rng.integers(0, 4)))
        out.append(dict(codes=codes, version=version, ids=ids,
                        delay=int(rng.integers(0, 3)),
                        dropped=bool(rng.random() < 0.1), uid=uid,
                        mutate=mutate, tick=bool(rng.random() < 0.4)))
    return out


def store_prov(store):
    return [(r.round, r.version, tuple(np.asarray(r.client_ids).tolist()),
             r.packed.nbytes) for r in store.records]


def ledger(q):
    return (q.bytes_sent, q.bytes_delivered, q.bytes_dropped,
            q.bytes_rejected, q.bytes_duplicate, q.bytes_in_flight, len(q))


def balanced(q):
    return q.bytes_sent == (q.bytes_delivered + q.bytes_dropped
                            + q.bytes_rejected + q.bytes_duplicate
                            + q.bytes_in_flight)


def services(wire, jwire, *, pol, **kw):
    """A port and a reference service with the same knobs and decode
    policy ``pol`` = (min_batch, max_batch, interval_ticks)."""
    return (SV.ContinuousIngestService(
                wire, decode_policy=SV.BulkDecodePolicy(*pol), **kw),
            JSV.ContinuousIngestService(
                jwire, decode_policy=JSV.BulkDecodePolicy(*pol), **kw))


def near_tie_equal(codes, want, feats, cb):
    """Codes equal to the reference's but at near ties of (feats, cb)."""
    f = feats.reshape(-1, feats.shape[-1]).double()
    c = torch.as_tensor(np.asarray(cb)).double()
    scores = (c * c).sum(-1)[None, :] - 2 * f @ c.T
    n_diff, outside = ref.code_mismatches(
        torch.as_tensor(np.array(codes)).reshape(-1),
        torch.as_tensor(np.array(want)).reshape(-1), scores)
    assert outside == 0 and n_diff <= max(1, 1e-3 * f.shape[0])


# ------------------------------------------------------------- the service

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("sharded", [False, True])
def test_service_verdicts_ledgers_and_decodes_match_reference(twins, seed,
                                                              sharded):
    wire, jwire = wires(twins, **(dict(n_shards=3, capacity_samples=6,
                                       policy="reservoir", seed=seed)
                                  if sharded else {}))
    register(wire, jwire, 2)
    svc, jsvc = services(wire, jwire, capacity=3, defer_depth=2,
                         pol=(2, 4, 2), dedup_window=6)
    for o in offers(seed):
        p, jp = payloads(o["codes"], o["version"], mutate=o["mutate"])
        res = svc.offer(p, client_ids=o["ids"], delay=o["delay"],
                        dropped=o["dropped"], uplink_id=o["uid"])
        jres = jsvc.offer(jp, client_ids=o["ids"], delay=o["delay"],
                          dropped=o["dropped"], uplink_id=o["uid"])
        assert (res.verdict, res.reason, res.nbytes, res.ok) == \
            (jres.verdict, jres.reason, jres.nbytes, jres.ok)
        if o["mutate"] is not None:
            assert res.verdict in ("rejected", "duplicate")
        if o["tick"]:
            assert tuple(svc.tick()) == tuple(jsvc.tick())
        assert ledger(svc.queue) == ledger(jsvc.queue)
        assert balanced(svc.queue)
    drained = [tuple(t) for t in svc.drain()]
    assert drained == [tuple(t) for t in jsvc.drain()]
    assert svc.verdicts == jsvc.verdicts
    assert svc.verdict_bytes == jsvc.verdict_bytes
    assert (svc.decoded_records, svc.decode_dispatches,
            svc.decode_amortization, svc.n_rejected, svc.n_deferred) == \
        (jsvc.decoded_records, jsvc.decode_dispatches,
         jsvc.decode_amortization, jsvc.n_rejected, jsvc.n_deferred)
    assert ledger(svc.queue) == ledger(jsvc.queue) and balanced(svc.queue)
    assert {"rejected", "accepted"} <= set(svc.verdicts)
    assert store_prov(wire.store) == store_prov(jwire.store)
    feats, labels = wire.features()
    jfeats, _ = jwire.features()
    np.testing.assert_array_equal(feats.numpy(), np.asarray(jfeats))


def test_wire_violations_are_rejected_at_the_door(twins):
    wire, jwire = wires(twins)
    svc, _ = services(wire, jwire, pol=(1, 64, 1))
    codes = np.zeros((1, 2, 4), np.int32)
    for mutate, reason in (("unprivatized", "unprivatized"),
                           ("wire", "wire_revision"), ("corrupt", "corrupt"),
                           ("short", "corrupt")):
        res = svc.offer(payloads(codes, 0, mutate=mutate)[0])
        assert (res.verdict, res.reason) == ("rejected", reason)
    res = svc.offer(payloads(codes, 3)[0])
    assert (res.verdict, res.reason) == ("rejected", "unknown_version")
    with pytest.raises(TypeError, match="CodePayload"):
        svc.offer(codes)
    assert len(svc.queue) == 0 and len(wire.store) == 0
    assert svc.queue.bytes_rejected == svc.queue.bytes_sent > 0
    relaxed = W.OctopusServer(wire.state, wire.cfg, device="cpu",
                              require_privatized=False)
    assert relaxed.precheck(payloads(codes, 0,
                                     mutate="unprivatized")[0]) == \
        ("accepted", "")


def test_duplicates_send_and_retry_policy_match_reference(twins):
    wire, jwire = wires(twins)
    svc, jsvc = services(wire, jwire, capacity=1, pol=(1, 64, 1))
    client, jclient = wire.deploy(client_id=5), JW.OctopusClient(
        jwire, client_id=5)
    pol, jpol = W.RetryPolicy(max_attempts=3), JW.RetryPolicy(max_attempts=3)
    for a in range(6):
        for salt in ("", "5.0", "17.3"):
            assert pol.backoff(a, salt=salt) == jpol.backoff(a, salt=salt)
    assert W.TRANSIENT_REASONS == JW.TRANSIENT_REASONS
    assert W.ADMISSION_VERDICTS == JW.ADMISSION_VERDICTS
    codes = np.arange(8, dtype=np.int32).reshape(1, 2, 4)
    p, jp = payloads(codes, 0)
    # the queue holds one: the first lands, the second waits on backoff
    # ticks until the queue drains, then lands
    results = [client.send(svc, p, retry=pol) for _ in range(2)]
    jresults = [jclient.send(jsvc, jp, retry=jpol) for _ in range(2)]
    assert [tuple(r[:3]) for r in results] == \
        [tuple(r[:3]) for r in jresults]
    assert svc.tick_idx == jsvc.tick_idx > 0
    # a retransmit of an admitted envelope is a duplicate, not stored again
    dup = svc.offer(p, client_ids=[5], uplink_id=(5, 0))
    jdup = jsvc.offer(jp, client_ids=[5], uplink_id=(5, 0))
    assert (dup.verdict, dup.reason) == (jdup.verdict, jdup.reason) == \
        ("duplicate", "dedup_window")
    assert not pol.retryable(dup)
    assert svc.queue.bytes_duplicate == jsvc.queue.bytes_duplicate > 0
    svc.drain(), jsvc.drain()
    assert len(wire.store) == len(jwire.store) == 2
    assert ledger(svc.queue) == ledger(jsvc.queue)


@pytest.mark.parametrize("policy", ["keep", "retire", "reencode"])
def test_migrations_match_reference(twins, policy):
    wire, jwire = wires(twins, n_shards=2)
    register(wire, jwire, 1)                 # v1
    svc, jsvc = services(wire, jwire, pol=(1, 64, 1))
    rng = np.random.default_rng(3)
    plan = [(rng.integers(0, 16, size=(2, 3, 4)).astype(np.int32), v, d)
            for v, d in ((0, 0), (0, 2), (1, 0), (0, 1), (1, 1))]
    win, jwin = svc.begin_migration(policy=policy), \
        jsvc.begin_migration(policy=policy)
    assert tuple(win) == tuple(jwin) == (0, 1, policy)
    for i, (codes, v, d) in enumerate(plan):
        p, jp = payloads(codes, v)
        res = svc.offer(p, client_ids=[i, i + 8], delay=d)
        jres = jsvc.offer(jp, client_ids=[i, i + 8], delay=d)
        assert (res.verdict, res.reason) == (jres.verdict, jres.reason)
        assert res.verdict == ("migrated" if v == 0 else "accepted")
        assert tuple(svc.tick()) == tuple(jsvc.tick())
        assert wire.migration_progress() == jwire.migration_progress()
    src_recs = [r for r in wire.store.records if r.version == 0]
    prog, jprog = svc.complete_migration(), jsvc.complete_migration()
    assert prog == jprog
    assert wire.registry.retired == jwire.registry.retired
    assert store_prov(wire.store) == store_prov(jwire.store)
    assert wire.store.evicted_bytes_by_version == \
        jwire.store.evicted_bytes_by_version
    for r, jr in zip(wire.store.records, jwire.store.records):
        got, want = r.packed.unpack(), np.asarray(jr.packed.unpack())
        if policy == "reencode" and r.version == 1 and r.round in \
                {s.round for s in src_recs}:
            src = next(s for s in src_recs if s.round == r.round)
            feats = OC.codes_to_features(wire.cfg, src.packed,
                                         wire.registry.get(0))
            near_tie_equal(got, want, feats, CODEBOOKS[0])
            np.testing.assert_array_equal(r.labels is None,
                                          jr.labels is None)
        else:
            np.testing.assert_array_equal(got.numpy(), want)
    if policy != "keep":
        p, jp = payloads(plan[0][0], 0)
        assert svc.offer(p).reason == jsvc.offer(jp).reason == \
            "retired_version"
    # (the remaining in-flight payload lands or is refused as the
    # reference's does)
    assert [tuple(t) for t in svc.drain()] == \
        [tuple(t) for t in jsvc.drain()]
    assert ledger(svc.queue) == ledger(jsvc.queue) and balanced(svc.queue)
    with pytest.raises(ValueError, match="no migration"):
        wire.migration_progress()


def test_reencode_refuses_gsvq_and_persist_waits_for_4b(twins, tmp_path):
    """Re-encoding refuses GSVQ; ``persist=`` takes a ServerPersistence
    and nothing else (it never runs unjournaled), and ``recover`` of a
    directory with no committed snapshot raises, as the reference's."""
    gcfg = DVQAEConfig(**dict(TINY, n_groups=4, n_slices=2))
    server = OC.server_init(0, gcfg, device="cpu")
    wire = W.OctopusServer(server, gcfg, device="cpu")
    with pytest.raises(ValueError, match="plain VQ"):
        wire._reencode_payload(payloads(np.zeros((1, 1, 4), np.int32),
                                        0)[0], 0)
    with pytest.raises(TypeError, match="ServerPersistence"):
        SV.ContinuousIngestService(wire, persist=object())
    with pytest.raises(FileNotFoundError, match="no committed snapshot"):
        SV.ContinuousIngestService.recover(str(tmp_path / "dir"), gcfg,
                                           server, device="cpu")


# ------------------------------------------------------- the round driver

def images(seed, n_slots, b=2):
    return np.random.default_rng(seed).standard_normal(
        (n_slots, b, 8, 8, 3)).astype(np.float32)


def test_async_full_participation_matches_engine_round(twins):
    _, path = twins
    server, cfg = port_server(path)
    data = images(1, 4)
    engine = SimEngine(cfg, gamma=0.9)
    sched = SV.RoundScheduler(4, SV.SchedulerConfig(), key=0)
    srv = SV.AsyncCodeServer(engine, server, sched, merge_every=0,
                             device="cpu")
    st = srv.run_round(torch.from_numpy(data))
    assert (st.n_participants, st.n_delivered) == (4, 1)
    clients, packed = engine.round(engine.init_clients(
        port_server(path)[0], 4), data)
    np.testing.assert_array_equal(
        srv.store.codes().numpy(),
        packed.unpack().reshape((-1,) + tuple(packed.shape[2:])).numpy())
    for got, want in zip(srv.clients.ema, clients.ema):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert srv.clients.step.tolist() == [1] * 4


@pytest.mark.parametrize("scenario,n_local", [("churn", 0),
                                              ("adversary", 0),
                                              ("partial", 1)])
def test_async_runtime_matches_reference(twins, scenario, n_local,
                                         monkeypatch):
    """Events, versions, byte accounting and stores equal the reference's;
    codes equal but at near ties of each client's own scores."""
    jserver, path = twins
    server, cfg = port_server(path)
    n_slots, rounds = 8, 8
    data = images(2, n_slots)
    labels = np.tile(np.arange(2), (n_slots, 1)).astype(np.int32)
    sc = SV.STANDARD_SCENARIOS[scenario]
    key = jax.random.fold_in(jax.random.PRNGKey(0), 3)
    srv = SV.AsyncCodeServer(
        SimEngine(cfg, gamma=0.9, n_local_steps=n_local), server,
        SV.RoundScheduler(n_slots, sc.sched,
                          key=np.asarray(jax.random.key_data(key))),
        merge_every=2, staleness_decay=0.5, device="cpu")
    jsrv = JSV.AsyncCodeServer(
        JEngine(JConfig(**TINY), gamma=0.9, n_local_steps=n_local), jserver,
        JSV.RoundScheduler(n_slots, sc.sched, key=key), merge_every=2,
        staleness_decay=0.5)
    seen = {}
    quantize = OC.quantize_indices

    def recording(cfg_, z, cb):
        seen.setdefault(srv.round, []).append((z.clone(), cb.clone()))
        return quantize(cfg_, z, cb)

    monkeypatch.setattr(OC, "quantize_indices", recording)
    for _ in range(rounds):
        st = srv.run_round(torch.from_numpy(data),
                           labels={"content": torch.from_numpy(labels)})
        jst = jsrv.run_round(jnp.asarray(data),
                             labels={"content": jnp.asarray(labels)})
        assert tuple(st) == tuple(jst)
        np.testing.assert_array_equal(srv.slot_versions, jsrv.slot_versions)
        np.testing.assert_array_equal(srv.scheduler.active,
                                      jsrv.scheduler.active)
    assert srv.n_merges == jsrv.n_merges == rounds // 2
    assert srv.registry.latest == jsrv.registry.latest
    assert ledger(srv.queue) == ledger(jsrv.queue) and balanced(srv.queue)
    assert store_prov(srv.store) == store_prov(jsrv.store)
    assert len(srv.store.versions) >= 2
    # codes: each client's row against the scores of its own round (the
    # port quantizes the participants in slot order)
    for rec, jrec in zip(srv.store.records, jsrv.store.records):
        got, want = rec.packed.unpack(), np.asarray(jrec.packed.unpack())
        parts = list(srv_participants(jsrv, rec.round))
        for j, slot in enumerate(rec.client_ids):
            z, cb = seen[rec.round][parts.index(int(slot))]
            near_tie_equal(got[j], want[j], z, cb)
    feats, lab = srv.dataset()
    jfeats, jlab = jsrv.dataset()
    assert feats.shape == jfeats.shape
    np.testing.assert_array_equal(lab["content"].numpy(),
                                  np.asarray(jlab["content"]))


def srv_participants(jsrv, round_idx):
    """The reference scheduler's participants of ``round_idx`` (a replay
    of its key: the stream is a pure function of it)."""
    s = JSV.RoundScheduler(jsrv.n_slots, jsrv.scheduler.cfg,
                           key=jsrv.scheduler._key)
    for _ in range(round_idx):
        s.step()
    return s.step().participants


# ------------------------------------------------------- cohort traffic

def data_fns(data):
    t = torch.from_numpy(data)
    return (lambda ids: t[torch.as_tensor(np.asarray(ids) % len(data))],
            lambda ids: jnp.asarray(data[np.asarray(ids) % len(data)]))


def cohort_twins(twins, **store_kw):
    wire, jwire = wires(twins, **store_kw)
    return (wire, jwire, CohortEngine(wire.cfg, gamma=0.9, n_local_steps=0),
            JCohort(jwire.cfg, gamma=0.9, n_local_steps=0))


TRAFFIC = dict(participation=0.5, straggler_prob=0.4, max_delay=2,
               drop_prob=0.2, leave_prob=0.1, join_prob=0.3)


def test_run_traffic_replays_and_matches_reference(twins):
    data = images(4, 12)
    fn, jfn = data_fns(data)
    runs = []
    for _ in range(2):
        wire, jwire, eng, jeng = cohort_twins(twins)
        hist = eng.run_traffic(
            wire, SV.RoundScheduler(12, SV.SchedulerConfig(**TRAFFIC),
                                    key=11), fn,
            cohort_size=3, n_rounds=6, merge_every=2)
        runs.append((hist, [r.packed.payload.clone()
                            for r in wire.store.records],
                     wire.registry.latest))
    jhist = jeng.run_traffic(
        jwire, JSV.RoundScheduler(12, JSV.SchedulerConfig(**TRAFFIC),
                                  key=jax.random.PRNGKey(11)), jfn,
        cohort_size=3, n_rounds=6, merge_every=2)
    (hist, words, latest), (hist2, words2, latest2) = runs
    assert hist == hist2 and latest == latest2
    assert all(torch.equal(a, b) for a, b in zip(words, words2))
    assert [tuple(h) for h in hist] == [tuple(h) for h in jhist]
    assert latest == jwire.registry.latest == 3
    assert store_prov(wire.store) == store_prov(jwire.store)


def test_run_continuous_replays_matches_reference_and_traces(twins,
                                                             tmp_path):
    data = images(5, 16)
    fn, jfn = data_fns(data)
    lab = np.arange(32).reshape(16, 2) % 3
    lfn = (lambda ids: {"content": torch.from_numpy(
        lab[np.asarray(ids) % 16])})
    jlfn = (lambda ids: {"content": jnp.asarray(lab[np.asarray(ids) % 16])})
    cfg = dict(rate=7.0, straggler_prob=0.4, max_delay=2, drop_prob=0.1,
               leave_prob=0.2, join_prob=0.5)

    def port_run(trace=None):
        wire, jwire, eng, jeng = cohort_twins(
            twins, n_shards=4, capacity_samples=24)
        svc, jsvc = services(wire, jwire, capacity=3, defer_depth=2,
                             pol=(2, 64, 2))
        sched = SV.RoundScheduler(16, SV.SchedulerConfig(**cfg), key=7)
        kw = dict(cohort_size=3, n_ticks=10, merge_every=3, labels_fn=lfn,
                  migration_policy="keep")
        if trace is None:
            hist = eng.run_continuous(svc, sched, fn, **kw)
        else:
            with obs.recording(str(trace)):
                hist = eng.run_continuous(svc, sched, fn, **kw)
                svc.drain()
                wire.features()
        return hist, svc, wire, jsvc, jwire, jeng

    hist, svc, wire, jsvc, jwire, jeng = port_run()
    hist2, svc2, wire2, *_ = port_run(trace=tmp_path / "port.jsonl")
    jhist = jeng.run_continuous(
        jsvc, JSV.RoundScheduler(16, JSV.SchedulerConfig(**cfg),
                                 key=jax.random.PRNGKey(7)), jfn,
        cohort_size=3, n_ticks=10, merge_every=3, labels_fn=jlfn,
        migration_policy="keep")
    assert hist == hist2
    assert [tuple(h) for h in hist] == [tuple(h) for h in jhist]
    assert svc.verdicts == svc2.verdicts == jsvc.verdicts
    assert svc.verdict_bytes == jsvc.verdict_bytes
    assert ledger(svc.queue) == ledger(jsvc.queue)
    assert store_prov(wire.store) == store_prov(jwire.store)
    assert all(torch.equal(a.packed.payload, b.packed.payload)
               for a, b in zip(wire.store.records, wire2.store.records))
    assert wire.registry.latest == jwire.registry.latest == 3
    assert svc.verdicts.get("rejected", 0) > 0
    # trace interop: the reference's report holds the port's byte ledger
    assert jreport.main([str(tmp_path / "port.jsonl"), "--check"]) == 0
    summary = jreport.summarize(jreport.load_events(
        str(tmp_path / "port.jsonl")))
    assert summary["kinds"].get("admission", 0) == \
        sum(svc2.verdicts.values())


# ------------------------------------------------------------ multi-task

def test_multitask_step_matches_reference():
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((40, 12)).astype(np.float32)
    ys = {"a": rng.integers(0, 3, 40).astype(np.int32),
          "b": rng.integers(0, 2, 40).astype(np.int32)}
    tasks = [SV.TaskSpec("a", 3), SV.TaskSpec("b", 2)]
    jt = JSV.MultiTaskTrainer(jax.random.PRNGKey(0),
                              [JSV.TaskSpec(*t) for t in tasks], 12,
                              hidden=16)
    pt = SV.MultiTaskTrainer(torch.Generator().manual_seed(0), tasks, 12,
                             hidden=16, device="cpu")
    pt.params = {n: probe_from_numpy({k: np.array(v) for k, v in
                                      jt.params[n].items()}, device="cpu")
                 for n in ("a", "b")}
    sel = rng.integers(0, 40, 16)
    for _ in range(2):
        jt.params, jt._opt = jt._step(
            jt.params, jt._opt, jnp.asarray(feats[sel]),
            {k: jnp.asarray(y[sel]) for k, y in ys.items()})
        pt.step(torch.from_numpy(feats[sel]),
                {k: torch.from_numpy(y[sel]) for k, y in ys.items()})
    for n in ("a", "b"):
        for k, v in jt.params[n].items():
            np.testing.assert_allclose(
                getattr(pt.params[n], k).detach().numpy(), np.asarray(v),
                rtol=1e-5, atol=1e-5)
    got = pt.accuracy(torch.from_numpy(feats),
                      {k: torch.from_numpy(y) for k, y in ys.items()})
    want = jt.accuracy(jnp.asarray(feats),
                       {k: jnp.asarray(y) for k, y in ys.items()})
    assert got == pytest.approx(want, abs=1.5 / 40)


def test_multitask_one_task_is_sgd_train_and_trains_all_heads():
    rng = np.random.default_rng(1)
    y1 = torch.from_numpy(rng.integers(0, 3, 120))
    y2 = torch.from_numpy(rng.integers(0, 2, 120))
    feats = torch.cat([torch.nn.functional.one_hot(y1, 3),
                       torch.nn.functional.one_hot(y2, 2)], -1).float()
    one = SV.MultiTaskTrainer(torch.Generator().manual_seed(3),
                              [SV.TaskSpec("label", 3)], 5, lr=1e-3,
                              device="cpu")
    one.fit(torch.Generator().manual_seed(4), feats, {"label": y1},
            steps=25, batch=32)
    probe = DS.LinearProbe(5, 3, generator=torch.Generator().manual_seed(3))
    DS.sgd_train(torch.Generator().manual_seed(4), probe, feats, y1,
                 steps=25, lr=1e-3, batch=32)
    for a, b in zip(one.params["label"].parameters(), probe.parameters()):
        assert torch.equal(a, b)
    two = SV.MultiTaskTrainer(torch.Generator().manual_seed(0),
                              [SV.TaskSpec("a", 3), SV.TaskSpec("b", 2)], 5,
                              device="cpu")
    two.fit(torch.Generator().manual_seed(0), feats, {"a": y1, "b": y2},
            steps=120, batch=64)
    acc = two.accuracy(feats, {"a": y1, "b": y2})
    assert acc["a"] > 0.9 and acc["b"] > 0.9
    with pytest.raises(ValueError, match="missing"):
        two.fit(torch.Generator(), feats, {"a": y1}, steps=1)
    with pytest.raises(ValueError, match="duplicate"):
        SV.MultiTaskTrainer(torch.Generator(), [SV.TaskSpec("a", 2)] * 2, 5,
                            device="cpu")


# --------------------------------------------------------------- drivers

def test_octopus_server_launcher_smoke(capsys):
    from repro_torch.launch import octopus_server
    out = octopus_server.main(["--smoke", "--device", "cpu"])
    assert sorted(out) == sorted(SV.STANDARD_SCENARIOS)
    for srv, acc, rps in out.values():
        assert balanced(srv.queue) and rps > 0
        assert set(acc) == {"content", "style"}
    text = capsys.readouterr().out
    assert "pretrain recon loss" in text and "[churn]" in text


def test_octopus_async_driver_runs_small(capsys):
    from repro_torch import octopus_async
    cfg = DVQAEConfig(kind="image", in_channels=3, hidden=16, latent_dim=16,
                      codebook_size=64, n_res_blocks=1)
    out = octopus_async.run(cfg, device="cpu", size=16, n_images=320,
                            pretrain_steps=10, ticks=12, probe_steps=20,
                            final_policy="reencode")
    s = out["service"]
    assert balanced(s.service.queue)
    assert out["final_migration"]["n_reencoded"] > 0
    assert s.wire.registry.retired
    assert set(out["accuracy"]) == {"content", "style"}
    text = capsys.readouterr().out
    assert "byte ledger conserved" in text and "bit-exact decode" in text
