"""The port's chaos plane against the reference's
(``repro_torch.sim.faults``, ``UplinkQueue.reorder_tail``).

* ``FaultyChannel``'s six substreams give the reference's generators for
  the same key (an int seed or two uint32 words): the same draws, so the
  same fault decisions, bit for bit.
* The ports of ``tests/test_chaos.py``'s fault-family, exactly-once and
  traced-run tests, each also run through the reference with the same key
  and payloads: the same fault histograms, verdicts, verdict bytes, byte
  ledgers, retries and stores.
* The ports of the three ``FIXED_CASES`` of
  ``tests/test_faults_properties.py`` (byte conservation at every step,
  nothing corrupt stored, one stored record per admitted verdict), each
  matching the reference's run of the same case.
* A traced faulted ``run_continuous`` passes the port's
  ``obs.report --check`` and the reference's ``repro.obs.report`` reads it
  with the same fault histogram.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro import server as JSV  # noqa: E402
from repro import sim as JSIM  # noqa: E402
from repro.core import octopus as JOC  # noqa: E402
from repro.core.dvqae import DVQAEConfig as JConfig  # noqa: E402
from repro.obs import report as jreport  # noqa: E402
from repro.wire import session as JW  # noqa: E402
from repro.wire.payload import CodePayload as JPayload  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch import server as SV  # noqa: E402
from repro_torch import sim as SIM  # noqa: E402
from repro_torch.core import octopus as OC  # noqa: E402
from repro_torch.core.dvqae import DVQAEConfig  # noqa: E402
from repro_torch.kernels.pack_bits import packing_dims  # noqa: E402
from repro_torch.obs import report  # noqa: E402
from repro_torch.sim import FAULT_KINDS, FaultPlan, FaultyChannel  # noqa: E402
from repro_torch.wire import session as W  # noqa: E402
from repro_torch.wire.payload import CodePayload  # noqa: E402

TINY = dict(kind="image", in_channels=3, hidden=8, latent_dim=8,
            codebook_size=16, n_res_blocks=1)
BITS = 4
N_CLIENTS = 12


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
def states():
    """A port and a reference server (the fault tests' payloads are
    synthetic, so the weights need not agree)."""
    cfg, jcfg = DVQAEConfig(**TINY), JConfig(**TINY)
    return (OC.server_init(0, cfg, device="cpu"), cfg,
            JOC.server_init(jax.random.PRNGKey(0), jcfg), jcfg)


def jplan(plan):
    return JSIM.FaultPlan(*plan)


def jretry(retry):
    return None if retry is None else JW.RetryPolicy(*retry)


def services(states, *, sharded=True, **kw):
    state, cfg, jstate, jcfg = states
    store = SV.ShardedCodeStore(cfg, n_shards=2) if sharded else None
    jstore = JSV.ShardedCodeStore(jcfg, n_shards=2) if sharded else None
    return (SV.ContinuousIngestService(
                W.OctopusServer(state, cfg, store=store, device="cpu"), **kw),
            JSV.ContinuousIngestService(
                JW.OctopusServer(jstate, jcfg, store=jstore), **kw))


def channels(states, plan, key, retry=None, **kw):
    """A port and a reference FaultyChannel with the same plan and key."""
    svc, jsvc = services(states, **kw)
    return (FaultyChannel(svc, plan, key=key, retry=retry),
            JSIM.FaultyChannel(jsvc, jplan(plan),
                               key=jax.random.PRNGKey(key),
                               retry=jretry(retry)))


def pack(seed, version=0, c=1, b=3, t=4):
    """The same numpy codes packed by both packages."""
    codes = np.random.default_rng(seed).integers(0, 16, size=(c, b, t))
    return (CodePayload.pack(torch.from_numpy(codes.astype(np.int32)),
                             bits=BITS, version=version),
            JPayload.pack(jnp.asarray(codes, jnp.int32), bits=BITS,
                          version=version))


def ledger(q):
    return (q.bytes_sent, q.bytes_delivered, q.bytes_dropped,
            q.bytes_rejected, q.bytes_duplicate, q.bytes_in_flight, len(q))


def conserved(q):
    return q.bytes_sent == (q.bytes_delivered + q.bytes_dropped
                            + q.bytes_rejected + q.bytes_duplicate
                            + q.bytes_in_flight)


def prov(store):
    return [(r.round, r.version, tuple(np.asarray(r.client_ids).tolist()),
             r.packed.nbytes) for r in store.records]


def same_outcome(chan, jchan):
    """The port's channel ended where the reference's did."""
    assert chan.faults == jchan.faults
    assert chan.retries == jchan.retries
    assert chan.verdicts == jchan.verdicts
    assert chan.verdict_bytes == jchan.verdict_bytes
    assert ledger(chan.queue) == ledger(jchan.queue)
    assert prov(chan.wire.store) == prov(jchan.wire.store)
    for r, jr in zip(chan.wire.store.records, jchan.wire.store.records):
        np.testing.assert_array_equal(
            r.packed.payload.numpy().view(np.uint32),
            np.asarray(jr.packed.payload))


# ------------------------------------------------------------ substreams

@pytest.mark.parametrize("key", [0, 3, 13, (123, 4567)])
def test_substreams_give_the_reference_draws(key, states):
    jkey = jax.random.PRNGKey(key) if isinstance(key, int) else \
        jnp.asarray(key, jnp.uint32)
    svc, jsvc = services(states)
    chan = FaultyChannel(svc, key=key)
    jchan = JSIM.FaultyChannel(jsvc, key=jkey)
    for idx in (0, 1, 2, 7, 31, 1000):
        for purpose in range(1, 7):
            g, jg = chan._rng(purpose, idx), jchan._rng(purpose, idx)
            assert g.random() == jg.random()
            assert g.integers(0, 2 ** 31, 4).tolist() == \
                jg.integers(0, 2 ** 31, 4).tolist()


def test_fault_kinds_and_plan_match_reference():
    assert FAULT_KINDS == JSIM.FAULT_KINDS
    assert FaultPlan._fields == JSIM.FaultPlan._fields
    assert FaultPlan() == tuple(JSIM.FaultPlan())
    assert not FaultPlan().active and FaultPlan(truncate=0.1).active
    assert SIM.FaultyChannel is FaultyChannel


def test_reorder_tail_matches_reference(states):
    svc, jsvc = services(states, sharded=False)
    assert not svc.queue.reorder_tail() and not jsvc.queue.reorder_tail()
    for i in range(3):
        p, jp = pack(i)
        svc.offer(p, client_ids=[i], delay=1)
        jsvc.offer(jp, client_ids=[i], delay=1)
    assert svc.queue.reorder_tail() and jsvc.queue.reorder_tail()
    assert [int(u.client_ids[0]) for u in svc.queue._pending] == \
        [int(u.client_ids[0]) for u in jsvc.queue._pending] == [0, 2, 1]


# ------------------------------------------------------- fault families

def test_drop_burns_bytes_stores_nothing(states):
    chan, jchan = channels(states, FaultPlan(drop=1.0), 1)
    for i in range(4):
        p, jp = pack(i)
        res = chan.offer(p, client_ids=[i])
        assert (res.verdict, res.reason) == ("rejected", "radio_drop")
        jchan.offer(jp, client_ids=[i])
    chan.drain()
    jchan.drain()
    assert chan.faults == {"drop": 4}
    assert len(chan.wire.store) == 0
    q = chan.queue
    assert q.bytes_dropped == q.bytes_sent > 0 and conserved(q)
    same_outcome(chan, jchan)


def test_duplicate_dedups_on_envelope(states):
    chan, jchan = channels(states, FaultPlan(duplicate=1.0), 2)
    for i in range(3):
        p, jp = pack(i)
        assert chan.offer(p, client_ids=[i]).verdict == "accepted"
        jchan.offer(jp, client_ids=[i])
    chan.drain()
    jchan.drain()
    assert chan.faults == {"duplicate": 3}
    assert chan.verdicts["duplicate"] == 3
    assert len(chan.wire.store) == 3            # each payload held ONCE
    assert chan.queue.bytes_duplicate > 0 and conserved(chan.queue)
    same_outcome(chan, jchan)


@pytest.mark.parametrize("plan", [FaultPlan(corrupt=1.0),
                                  FaultPlan(truncate=1.0)],
                         ids=["corrupt", "truncate"])
def test_corrupt_and_truncate_rejected_by_crc(states, plan):
    """A word-level bit flip or a cut stream -> rejected/corrupt at the
    door, bytes ledgered; the port's corrupted words equal the
    reference's."""
    chan, jchan = channels(states, plan, 3)
    seen, jseen = [], []
    chan.service.offer = _recording(chan.service.offer, seen)
    jchan.service.offer = _recording(jchan.service.offer, jseen)
    for i in range(3):
        p, jp = pack(i, b=9)
        res = chan.offer(p, client_ids=[i])
        assert (res.verdict, res.reason) == ("rejected", "corrupt")
        jchan.offer(jp, client_ids=[i])
    chan.drain()
    jchan.drain()
    assert sum(chan.faults.values()) == 3
    assert len(chan.wire.store) == 0
    assert chan.queue.bytes_rejected == chan.queue.bytes_sent > 0
    assert conserved(chan.queue)
    same_outcome(chan, jchan)
    for p, jp in zip(seen, jseen):
        assert not p.verify()
        np.testing.assert_array_equal(p.payload.numpy().view(np.uint32),
                                      np.asarray(jp.payload))


def _recording(offer, log):
    def shim(p, **kw):
        log.append(p)
        return offer(p, **kw)
    return shim


def test_delay_holds_delivery_within_bound(states):
    chan, jchan = channels(states, FaultPlan(delay=1.0, max_delay=3), 4)
    p, jp = pack(0)
    assert chan.offer(p, client_ids=[0]).verdict == "accepted"
    jchan.offer(jp, client_ids=[0])
    assert chan.faults == {"delay": 1}
    first = chan.tick()
    jfirst = jchan.tick()
    assert first.n_delivered == 0 == jfirst.n_delivered
    hist = [first] + chan.drain()
    jhist = [jfirst] + jchan.drain()
    assert [tuple(h) for h in hist] == [tuple(h) for h in jhist]
    assert sum(t.n_delivered for t in hist) == 1
    assert len(hist) <= 1 + 3                   # lands within max_delay
    assert len(chan.wire.store) == 1 and conserved(chan.queue)
    same_outcome(chan, jchan)


def test_reorder_swaps_arrival_order(states):
    chan, jchan = channels(states, FaultPlan(reorder=1.0), 5, sharded=False)
    (a, ja), (b, jb) = pack(10), pack(11)
    chan.offer(a, client_ids=[0])               # alone: nothing to swap
    chan.offer(b, client_ids=[1])
    jchan.offer(ja, client_ids=[0])
    jchan.offer(jb, client_ids=[1])
    assert chan.faults == {"reorder": 1}
    chan.drain()
    jchan.drain()
    words = [r.packed.payload for r in chan.wire.store.records]
    assert torch.equal(words[0], b.payload)
    assert torch.equal(words[1], a.payload)
    assert conserved(chan.queue)
    same_outcome(chan, jchan)


def test_fault_families_draw_independent_substreams(states):
    """Enabling corruption must not change WHICH sends drop."""
    def drops(plan):
        chan, jchan = channels(states, plan, 6)
        out = []
        for i in range(30):
            p, jp = pack(i)
            res = chan.offer(p, client_ids=[i])
            jres = jchan.offer(jp, client_ids=[i])
            assert (res.verdict, res.reason) == (jres.verdict, jres.reason)
            out.append(res.reason == "radio_drop")
        return out
    base = drops(FaultPlan(drop=0.3))
    assert 1 <= sum(base) <= 29                 # chaos actually mixed
    assert drops(FaultPlan(drop=0.3, corrupt=0.9, delay=0.5)) == base


def test_channel_is_deterministic_under_key(states):
    from repro_torch.wire.session import RetryPolicy

    def go():
        chan, jchan = channels(
            states,
            FaultPlan(drop=0.2, duplicate=0.2, reorder=0.3, delay=0.3,
                      corrupt=0.15, truncate=0.1),
            7, retry=RetryPolicy(max_attempts=2))
        for i in range(25):
            p, jp = pack(i)
            chan.offer(p, client_ids=[i % 5])
            jchan.offer(jp, client_ids=[i % 5])
            chan.tick()
            jchan.tick()
        chan.drain()
        jchan.drain()
        return chan, jchan
    (a, ja), (b, _) = go(), go()
    assert a.faults == b.faults and sum(a.faults.values()) > 0
    assert a.verdicts == b.verdicts and a.retries == b.retries
    assert a.queue.bytes_sent == b.queue.bytes_sent
    assert len(a.wire.store) == len(b.wire.store)
    same_outcome(a, ja)


# --------------------------------------------------------- exactly-once

def test_retry_loop_is_exactly_once(states):
    from repro_torch.wire.session import RetryPolicy
    chan, jchan = channels(states, FaultPlan(drop=0.4, duplicate=0.3), 8,
                           retry=RetryPolicy(max_attempts=4, base_ticks=1,
                                             cap_ticks=4))
    n = 20
    for i in range(n):
        p, jp = pack(i)
        chan.offer(p, client_ids=[i])
        jchan.offer(jp, client_ids=[i])
        chan.tick()
        jchan.tick()
    chan.drain()
    jchan.drain()
    assert chan.retries > 0 and chan.faults.get("drop", 0) > 0
    assert len(chan.wire.store) <= n
    admitted = sum(chan.verdicts.get(v, 0)
                   for v in ("accepted", "deferred", "migrated"))
    assert len(chan.wire.store) == admitted and conserved(chan.queue)
    same_outcome(chan, jchan)


def test_client_send_retries_through_faulty_channel(states):
    """OctopusClient.send drives its own retry loop against the channel
    and lands exactly once even when the first attempts drop."""
    from repro_torch.wire.session import RetryPolicy
    state, cfg, _, _ = states
    svc, _ = services(states)
    chan = FaultyChannel(svc, FaultPlan(drop=0.5), key=9)
    cl = W.OctopusServer(state, cfg, device="cpu").deploy(client_id=3)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 8, 8, 3)).astype(np.float32))
    results = [cl.uplink(chan, x, retry=RetryPolicy(max_attempts=6))
               for _ in range(6)]
    chan.drain()
    landed = sum(1 for r in results if r.ok and r.verdict != "duplicate")
    assert len(svc.wire.store) == landed > 0
    assert chan.faults.get("drop", 0) > 0
    assert conserved(svc.queue)


# ------------------------------------------------ the fixed property cases

def words_payload(n_samples, fill):
    """A (1, n_samples, 3)-shaped stamped payload from raw words, in both
    packages."""
    G, Wd = packing_dims(BITS)
    rows = max(2, (n_samples * 3 + G - 1) // G)   # >= 2 rows: truncatable
    words = np.full((rows, Wd), fill, dtype=np.uint32)
    return (CodePayload.from_words(torch.from_numpy(words.view(np.int32)),
                                   bits=BITS, shape=(1, n_samples, 3)),
            JPayload.from_words(jnp.asarray(words), bits=BITS,
                                shape=(1, n_samples, 3)))


FIXED_CASES = [
    (FaultPlan(drop=1.0, duplicate=1.0), [(0, 2, True), (1, 3, False)],
     None),
    (FaultPlan(corrupt=1.0, truncate=0.4, delay=0.4),
     [(c, 2, c % 2 == 0) for c in range(6)], None),
    (FaultPlan(drop=0.4, duplicate=0.4, reorder=0.4, delay=0.4,
               corrupt=0.4, truncate=0.4),
     [(c % 4, 1 + c % 3, c % 2 == 0) for c in range(12)],
     (2, 1, 2)),
]


@pytest.mark.parametrize("plan,stream,retry", FIXED_CASES,
                         ids=["drop_dup", "corrupt_truncate", "all"])
def test_chaos_invariants_fixed(states, plan, stream, retry):
    from repro_torch.wire.session import RetryPolicy
    retry = None if retry is None else RetryPolicy(
        max_attempts=retry[0], base_ticks=retry[1], cap_ticks=retry[2])
    chan, jchan = channels(states, plan, 13, retry=retry, sharded=False,
                           capacity=8)
    for i, (cid, n, tick_after) in enumerate(stream):
        p, jp = words_payload(n, fill=i)
        chan.offer(p, client_ids=[cid])
        jchan.offer(jp, client_ids=[cid])
        assert conserved(chan.queue)
        if tick_after:
            chan.tick()
            jchan.tick()
    chan.drain()
    jchan.drain()
    q = chan.queue
    assert q.bytes_in_flight == 0
    assert q.bytes_sent == (q.bytes_delivered + q.bytes_dropped
                            + q.bytes_rejected + q.bytes_duplicate)
    for rec in chan.wire.store.records:         # nothing corrupt landed
        assert rec.packed.verify()
    admitted = sum(chan.verdicts.get(v, 0)
                   for v in ("accepted", "deferred", "migrated"))
    assert len(chan.wire.store) == admitted
    same_outcome(chan, jchan)


# ----------------------------------------------------- traced chaos run

def test_engine_payloads_carry_a_crc_the_references_do_not(states):
    """The reference's ``SimEngine.round`` builds its cohort payload
    without ``stamped()`` (``repro/sim/engine.py:173``), so a bit flip in
    a cohort payload passes its admission (length check only) and is
    stored. The port's engine stamps the CRC that the reference's
    ``payload_crc`` gives the same words, so admission refuses the flip."""
    from repro.wire.payload import payload_crc as jcrc
    from repro_torch.sim import SimEngine
    state, cfg, jstate, jcfg = states
    x = np.random.default_rng(1).standard_normal((3, 2, 8, 8, 3)) \
        .astype(np.float32)
    eng = SimEngine(cfg, n_local_steps=0)
    _, p = eng.round(eng.init_clients(state, 3), torch.from_numpy(x))
    jeng = JSIM.SimEngine(jcfg, n_local_steps=0)
    _, jp = jeng.round(jeng.init_clients(jstate, 3), jnp.asarray(x))
    assert jp.checksum is None and p.checksum is not None
    assert p.checksum == jcrc(p.payload.numpy().view(np.uint32),
                              bits=p.bits, shape=p.shape,
                              n_records=p.n_records, version=p.version)
    flip = FaultyChannel._flip_bit(p, np.random.default_rng(0))
    jflip = JSIM.FaultyChannel._flip_bit(jp, np.random.default_rng(0))
    assert not flip.verify() and jflip.verify()


def test_chaos_run_continuous_conserves_and_traces(states, tmp_path,
                                                   monkeypatch):
    """The cohort engine drives a FAULTED service unchanged; the port's
    trace passes both packages' report checks with the fault histogram
    the channel counted; verdicts, faults and ledgers equal the
    reference's run under the same keys, its engine payloads stamped as
    the port's are (see the test above)."""
    from repro.sim.engine import SimEngine as JEngine
    from repro_torch.wire.session import RetryPolicy
    real = JEngine.round

    def stamped(self, *a, **kw):
        clients, p = real(self, *a, **kw)
        return clients, p.stamped()
    monkeypatch.setattr(JEngine, "round", stamped)
    state, cfg, jstate, jcfg = states
    data = np.random.default_rng(1).standard_normal(
        (N_CLIENTS, 2, 8, 8, 3)).astype(np.float32)
    t = torch.from_numpy(data)
    plan = FaultPlan(drop=0.15, duplicate=0.15, reorder=0.2, delay=0.3,
                     corrupt=0.1, truncate=0.1)
    sched_kw = dict(rate=6.0, straggler_prob=0.4, max_delay=2,
                    drop_prob=0.1)
    chan, jchan = channels(states, plan, 11, retry=RetryPolicy(3),
                           capacity=4, defer_depth=3)
    trace = tmp_path / "chaos.jsonl"
    with obs.recording(str(trace)):
        hist = SIM.CohortEngine(cfg, gamma=0.9, n_local_steps=0) \
            .run_continuous(chan, SV.RoundScheduler(
                N_CLIENTS, SV.SchedulerConfig(**sched_kw), key=12),
                lambda ids: t[torch.as_tensor(np.asarray(ids))],
                cohort_size=3, n_ticks=8, merge_every=3,
                migration_policy="keep")
        chan.drain()
    jhist = JSIM.CohortEngine(jcfg, gamma=0.9, n_local_steps=0) \
        .run_continuous(jchan, JSV.RoundScheduler(
            N_CLIENTS, JSV.SchedulerConfig(**sched_kw),
            key=jax.random.PRNGKey(12)),
            lambda ids: jnp.asarray(data[np.asarray(ids)]),
            cohort_size=3, n_ticks=8, merge_every=3,
            migration_policy="keep")
    jchan.drain()
    assert len(hist) == 8 and sum(chan.faults.values()) > 0
    assert conserved(chan.queue)
    assert [tuple(h) for h in hist] == [tuple(h) for h in jhist]
    assert chan.faults == jchan.faults and chan.retries == jchan.retries
    assert chan.verdicts == jchan.verdicts
    assert ledger(chan.queue) == ledger(jchan.queue)
    assert prov(chan.wire.store) == prov(jchan.wire.store)
    assert report.main([str(trace), "--check"]) == 0
    for rep in (report, jreport):
        summary = rep.summarize(rep.load_events(str(trace)))
        assert rep.check_bytes(summary) == []
        assert dict(summary["faults"]) == chan.faults
        assert set(summary["faults"]) <= set(FAULT_KINDS)
