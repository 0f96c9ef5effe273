"""Crash-consistent ingest on the port (``repro_torch.server.persist``, the
service's journal hooks and ``recover``) against the reference's.

* Kill-and-recover: a journaled, faulted ``run_continuous`` killed after
  2, 5 and 7 ticks (snapshots every 3) recovers to the crashed service's
  tick, verdicts, verdict bytes, six ledger fields, store, latest version,
  open window and bit-identical features; killed mid-migration it replays
  back INTO the window and can complete it; recovered, it continues
  exactly as the uninterrupted service does.
* Across the packages, both ways: a directory written by the reference's
  journaled service is recovered by the port, and one written by the port
  is recovered by the reference, each equal to the other package's crashed
  service in verdicts, verdict bytes, ledgers, tick, window and decoded
  features.
* A snapshot without its manifest is not committed (recovery falls back to
  the one before and replays a longer tail); a torn journal line is
  skipped; an unknown entry kind raises; no snapshot raises
  ``FileNotFoundError``.
* The chaos-soak driver on the CPU: its drill passes, the door refused
  every corrupted or truncated payload it saw, the encode and decode
  dispatches equal the counts its host records give, and its trace passes
  the port's ``obs.report --check`` and the reference's.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro import server as JSV  # noqa: E402
from repro import sim as JSIM  # noqa: E402
from repro.checkpoint.npz import save_pytree  # noqa: E402
from repro.core import octopus as JOC  # noqa: E402
from repro.core.dvqae import DVQAEConfig as JConfig  # noqa: E402
from repro.obs import report as jreport  # noqa: E402
from repro.wire import session as JW  # noqa: E402
from repro_torch import chaos_soak  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch import server as SV  # noqa: E402
from repro_torch.convert import load_npz  # noqa: E402
from repro_torch.core import octopus as OC  # noqa: E402
from repro_torch.core.dvqae import DVQAEConfig  # noqa: E402
from repro_torch.kernels.pack_bits import code_bits  # noqa: E402
from repro_torch.obs import dispatch_monitor, report  # noqa: E402
from repro_torch.sim import (CohortEngine, FaultPlan,  # noqa: E402
                             FaultyChannel)
from repro_torch.wire import session as W  # noqa: E402
from repro_torch.wire.payload import CodePayload  # noqa: E402

TINY = dict(kind="image", in_channels=3, hidden=8, latent_dim=8,
            codebook_size=16, n_res_blocks=1)
N_CLIENTS = 12
PLAN = dict(drop=0.2, duplicate=0.2, delay=0.3, corrupt=0.1)
SCHED = dict(rate=5.0, straggler_prob=0.3, max_delay=2)
LEDGER = ("bytes_sent", "bytes_delivered", "bytes_dropped",
          "bytes_rejected", "bytes_duplicate", "bytes_in_flight")


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
    """The reference's TINY server, the port's on the same weights, and
    the clients' images."""
    jcfg = JConfig(**TINY)
    jstate = JOC.server_init(jax.random.PRNGKey(0), jcfg)
    path = str(tmp_path_factory.mktemp("persist") / "params.npz")
    save_pytree(path, jstate.params)
    cfg = DVQAEConfig(**TINY)
    data = np.random.default_rng(1).standard_normal(
        (N_CLIENTS, 2, 8, 8, 3)).astype(np.float32)
    return jstate, jcfg, path, cfg, data


def port_state(twins):
    _, _, path, cfg, _ = twins
    return OC.server_init(0, cfg, device="cpu")._replace(
        params=load_npz(path, cfg, device="cpu"))


def port_run(twins, root, *, n_ticks, snapshot_every=3, kill=True,
             plan=PLAN, sharded=True):
    """One journaled faulted run of the port -> the service, killed (its
    journal handle closed) unless ``kill=False``."""
    _, _, _, cfg, data = twins
    t = torch.from_numpy(data)
    persist = SV.ServerPersistence(str(root), snapshot_every=snapshot_every)
    svc = SV.ContinuousIngestService(
        W.OctopusServer(port_state(twins), cfg,
                        store=(SV.ShardedCodeStore(cfg, n_shards=2)
                               if sharded else None),
                        device="cpu"), capacity=6, persist=persist)
    chan = FaultyChannel(svc, FaultPlan(**plan), key=21,
                         retry=W.RetryPolicy(max_attempts=2))
    CohortEngine(cfg, gamma=0.9, n_local_steps=0).run_continuous(
        chan, SV.RoundScheduler(N_CLIENTS, SV.SchedulerConfig(**SCHED),
                                key=22),
        lambda ids: t[torch.as_tensor(np.asarray(ids))], cohort_size=3,
        n_ticks=n_ticks, merge_every=3, migration_policy="keep")
    if kill:
        persist.journal.close()         # the killed process's handle
    return svc


def reference_run(twins, root, *, n_ticks, snapshot_every=3, plan=PLAN,
                  sharded=True):
    """The same run through the reference -> its (killed) service."""
    jstate, jcfg, _, _, data = twins
    persist = JSV.ServerPersistence(str(root),
                                    snapshot_every=snapshot_every)
    svc = JSV.ContinuousIngestService(
        JW.OctopusServer(jstate, jcfg,
                         store=(JSV.ShardedCodeStore(jcfg, n_shards=2)
                                if sharded else None)),
        capacity=6, persist=persist)
    chan = JSIM.FaultyChannel(svc, JSIM.FaultPlan(**plan),
                              key=jax.random.PRNGKey(21),
                              retry=JW.RetryPolicy(max_attempts=2))
    JSIM.CohortEngine(jcfg, gamma=0.9, n_local_steps=0).run_continuous(
        chan, JSV.RoundScheduler(N_CLIENTS, JSV.SchedulerConfig(**SCHED),
                                 key=jax.random.PRNGKey(22)),
        lambda ids: jnp.asarray(data[np.asarray(ids)]), cohort_size=3,
        n_ticks=n_ticks, merge_every=3, migration_policy="keep")
    persist.journal.close()
    return svc


def recover(twins, root, **kw):
    return SV.ContinuousIngestService.recover(
        str(root), twins[3], None, device="cpu", capacity=6, **kw)


def window(svc):
    w = svc.wire.registry.migration
    return None if w is None else (int(w.src), int(w.dst), str(w.policy))


def assert_same(a, b):
    """Two services (either package) agree exactly."""
    assert a.tick_idx == b.tick_idx
    assert a.verdicts == b.verdicts
    assert a.verdict_bytes == b.verdict_bytes
    for attr in LEDGER:
        assert getattr(a.queue, attr) == getattr(b.queue, attr), attr
    assert len(a.wire.store) == len(b.wire.store)
    assert a.wire.registry.latest == b.wire.registry.latest
    assert window(a) == window(b)
    fa, _ = a.wire.features()
    fb, _ = b.wire.features()
    np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))


def pack(seed, version, c=1, b=3, t=4):
    codes = np.random.default_rng(seed).integers(0, 16, size=(c, b, t))
    return CodePayload.pack(torch.from_numpy(codes.astype(np.int32)),
                            bits=code_bits(16), version=version)


# ------------------------------------------------------------- recovery

@pytest.mark.parametrize("n_ticks", [2, 5, 7])
def test_recover_from_kill_at_any_tick(twins, tmp_path, n_ticks):
    svc = port_run(twins, tmp_path / "srv", n_ticks=n_ticks)
    rec = recover(twins, tmp_path / "srv")
    assert_same(svc, rec)
    assert rec.recovery["snapshot_tick"] == 3 * (n_ticks // 3)
    assert rec.recovery["n_replayed"] > 0


def test_recover_mid_migration_reopens_window(twins, tmp_path):
    svc = port_run(twins, tmp_path / "srv", n_ticks=7)
    win = svc.wire.registry.migration
    assert win is not None                      # merge at tick 6 opened it
    rec = recover(twins, tmp_path / "srv")
    assert window(rec) == window(svc)
    assert_same(svc, rec)
    # the recovered service is LIVE: complete the window and keep going
    rec.complete_migration()
    assert rec.wire.registry.migration is None
    assert rec.offer(pack(99, rec.wire.version), client_ids=[0]).ok
    rec.drain()
    entries = list(rec._persist.journal.entries())
    assert entries[-1]["kind"] == "tick"
    assert {"kind": "migration", "phase": "complete", "src": None,
            "dst": None, "policy": None} in entries


def test_recovered_service_continues_identically(twins, tmp_path):
    svc = port_run(twins, tmp_path / "srv", n_ticks=5, kill=False)
    rec = recover(twins, tmp_path / "srv")
    for s in (svc, rec):
        for i in range(4):
            s.offer(pack(100 + i, s.wire.version), client_ids=[i],
                    uplink_id=(i, 1000))
        s.drain()
        s._persist.journal.close()
    assert_same(svc, rec)


def test_reorders_are_journaled_and_replayed(twins, tmp_path):
    """The channel's reorders go through the service and are journaled, so
    a kill after swapped payloads landed in one store partition recovers
    their order. The reference's channel swaps the queue unjournaled: in
    the same run its own recovery rebuilds the store in another order."""
    def order(svc):
        return [(r.round, tuple(np.asarray(r.client_ids).tolist()))
                for r in svc.wire.store.records]
    kw = dict(n_ticks=5, plan=dict(PLAN, reorder=1.0), sharded=False)
    svc = port_run(twins, tmp_path / "port", **kw)
    rec = recover(twins, tmp_path / "port")
    assert_same(svc, rec)
    assert order(svc) == order(rec)
    assert any(e["kind"] == "reorder" for e in
               rec._persist.journal.entries(start=0))
    jstate, jcfg, _, _, _ = twins
    jsvc = reference_run(twins, tmp_path / "ref", **kw)
    jrec = JSV.ContinuousIngestService.recover(
        str(tmp_path / "ref"), jcfg,
        JOC.server_init(jax.random.PRNGKey(0), jcfg), capacity=6)
    assert order(jsvc) == order(svc)
    assert order(jrec) != order(jsvc)


# ------------------------------------------------------ across packages

def test_port_recovers_a_reference_written_directory(twins, tmp_path):
    jsvc = reference_run(twins, tmp_path / "ref", n_ticks=7)
    assert jsvc.wire.registry.migration is not None
    rec = recover(twins, tmp_path / "ref")
    assert_same(jsvc, rec)
    # and serves on: the recovered port service journals in the same file
    assert rec.offer(pack(7, rec.wire.version), client_ids=[1]).ok
    rec.tick()
    assert rec._persist.journal.position > rec.recovery["n_replayed"]


def test_reference_recovers_a_port_written_directory(twins, tmp_path):
    jstate, jcfg, _, _, _ = twins
    svc = port_run(twins, tmp_path / "port", n_ticks=7)
    assert svc.wire.registry.migration is not None
    jrec = JSV.ContinuousIngestService.recover(
        str(tmp_path / "port"), jcfg,
        JOC.server_init(jax.random.PRNGKey(0), jcfg), capacity=6)
    assert_same(svc, jrec)


def test_port_journal_and_snapshot_follow_the_reference_layout(twins,
                                                               tmp_path):
    svc = port_run(twins, tmp_path / "port", n_ticks=4)
    jsvc = reference_run(twins, tmp_path / "ref", n_ticks=4)
    def listing(d):       # the reference's save_pytree leaves tmp files
        return sorted(f for f in os.listdir(d) if not f.startswith("tmp"))
    files = listing(tmp_path / "port")
    assert files == listing(tmp_path / "ref")
    assert len(files) == 1 + 3 * 2            # snapshots 0 and 3
    assert "journal.jsonl" in files and "snap_00000003.state.npz" in files
    kinds = [e["kind"] for e in SV.ServerPersistence(
        str(tmp_path / "port"), resume=True).journal.entries()]
    jkinds = [e["kind"] for e in JSV.ServerPersistence(
        str(tmp_path / "ref"), resume=True).journal.entries()]
    assert kinds == jkinds
    offer = next(e for e in SV.ServerPersistence(
        str(tmp_path / "port"), resume=True).journal.entries()
        if e["kind"] == "offer")
    assert offer["words"]["dtype"] == "uint32"
    with open(tmp_path / "port" / "snap_00000003.json") as fh:
        man = json.load(fh)
    with open(tmp_path / "ref" / "snap_00000003.json") as fh:
        jman = json.load(fh)
    assert set(man) == set(jman)
    assert set(man["service"]) == set(jman["service"])
    assert man["service"]["verdicts"] == jman["service"]["verdicts"]
    assert man["queue"].keys() == jman["queue"].keys()
    assert svc.verdicts == jsvc.verdicts


# --------------------------------------------------------- crash edges

def test_uncommitted_snapshot_and_torn_tail(twins, tmp_path):
    root = tmp_path / "srv"
    svc = port_run(twins, root, n_ticks=7)
    os.remove(root / "snap_00000006.json")     # killed mid-snapshot
    with open(root / "journal.jsonl", "a") as fh:
        fh.write('{"kind": "tick"')             # killed mid-append
    rec = recover(twins, root)
    assert rec.recovery["snapshot_tick"] == 3
    assert_same(svc, rec)


def test_unknown_entry_and_missing_snapshot_raise(twins, tmp_path):
    root = tmp_path / "srv"
    port_run(twins, root, n_ticks=2)
    with open(root / "journal.jsonl", "a") as fh:
        fh.write(json.dumps({"kind": "compaction"}) + "\n")
    with pytest.raises(ValueError, match="unknown kind 'compaction'"):
        recover(twins, root)
    with open(root / "journal.jsonl", "a") as fh:
        fh.write(json.dumps({"kind": "migration", "phase": "abort"}) + "\n")
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="no committed snapshot"):
        recover(twins, empty)
    with pytest.raises(TypeError, match="ServerPersistence"):
        SV.ContinuousIngestService(
            W.OctopusServer(port_state(twins), twins[3], device="cpu"),
            persist=str(root))


# ------------------------------------------------------------ the driver

def test_chaos_soak_driver_drill_door_counts_and_trace(tmp_path,
                                                       monkeypatch, capsys):
    trace = tmp_path / "chaos.jsonl"
    monkeypatch.setenv("OCTOPUS_TRACE", str(trace))
    with dispatch_monitor() as n:
        out = chaos_soak.run(device="cpu", n_images=320, pretrain_steps=5)
    text = capsys.readouterr().out
    for line in ("byte ledger conserved under chaos: OK",
                 "decoded features EXACT", "bit-exact decode for versions"):
        assert line in text
    crashed, rec = out["crashed"], out["recovered"]
    assert crashed.wire.registry.migration is not None
    assert all(out["faults"].get(k, 0) > 0 for k in
               ("drop", "duplicate", "reorder", "delay", "corrupt",
                "truncate"))
    assert out["retries"] > 0 and rec.recovery["n_replayed"] > 0
    # every payload whose words fail their check was refused at the door
    # (as corrupt, or as the duplicate of an envelope already admitted)
    refused = {}
    for d in out["door"].values():
        for k, v in d.items():
            refused[k] = refused.get(k, 0) + v
    assert refused.get("rejected/corrupt", 0) > 0
    assert set(refused) <= {"rejected/corrupt", "duplicate/dedup_window"}
    assert all(r.packed.verify() for r in rec.wire.store.records)
    # the dispatches equal what the host's records say: nothing refused
    # reached the decode
    assert n.encode_dispatches == chaos_soak.encode_dispatches(out)
    assert n.decode_dispatches == chaos_soak.decode_dispatches(out)
    # the trace: the port's check and the reference's
    assert report.main([str(trace), "--check"]) == 0
    assert jreport.main([str(trace), "--check"]) == 0
    summary = jreport.summarize(jreport.load_events(str(trace)))
    assert summary["recoveries"] and summary["retries"] == out["retries"]
    want = dict(out["faults"])
    for k, v in out["faults_after"].items():
        want[k] = want.get(k, 0) + v
    assert dict(summary["faults"]) == want
