"""Chaos soak + crash drill: faulted uplinks into a journaled service, then
a mid-migration kill and a bit-exact recovery.

    PYTHONPATH=src python -m repro_torch.chaos_soak

The PyTorch copy of ``examples/chaos_soak.py``, with its knobs, config and
checks, on ``cuda`` (``run(cfg, device="cpu")`` runs it on the CPU). Every
cohort payload crosses a ``FaultyChannel`` that drops, duplicates,
reorders, delays, corrupts and truncates on its own key substreams;
clients retransmit transient failures under ``(client_id, seq)``
envelopes, so ingest stays exactly-once; every admitted offer, refusal,
tick, merge and migration op is journaled through ``ServerPersistence``
with a snapshot every 5 ticks.

After the soak the service is KILLED (abandoned with a migration window
open and payloads in flight) and ``ContinuousIngestService.recover``
rebuilds it from the latest snapshot and the journal tail. The drill holds
the recovered tick, verdicts, verdict bytes, byte ledger, store, registry,
open window and decoded features EXACTLY equal to the crashed service's,
then serves more faulted traffic on the recovered instance and checks that
every stored record decodes bit-exactly against its pinned version.

Every payload that reaches the admission door is logged (:class:`Door`):
the drill checks that each one whose words fail their integrity check
(a corrupted or truncated stream) was refused there, and that no stored
record fails it.

Set ``OCTOPUS_TRACE=chaos.jsonl`` to flight-record the run, then audit it
with ``python -m repro_torch.obs.report chaos.jsonl --check``. The channel
and scheduler keys are the example's (3, 7 and 4), so the fault decisions
and the arrival stream are the reference's.
"""
from __future__ import annotations

import os
import tempfile
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.core import octopus as OC
from repro_torch.core.dvqae import DVQAEConfig
from repro_torch.data.federated import partition_stacked
from repro_torch.data.synthetic import LabeledData, make_images
from repro_torch.octopus_async import pretrained
from repro_torch.server import (BulkDecodePolicy, ContinuousIngestService,
                                RoundScheduler, SchedulerConfig,
                                ServerPersistence, ShardedCodeStore)
from repro_torch.sim import CohortEngine, FaultPlan, FaultyChannel
from repro_torch.wire.session import OctopusServer, RetryPolicy

N_SLOTS, COHORT, TICKS = 16, 4, 12
PLAN = FaultPlan(drop=0.15, duplicate=0.15, reorder=0.2, delay=0.3,
                 corrupt=0.1, truncate=0.1)
CHANNEL_KEY, SCHED_KEY, RECOVERED_KEY = 3, 7, 4
MERGE_EVERY, SNAPSHOT_EVERY = 4, 5
LEDGER = ("bytes_sent", "bytes_delivered", "bytes_dropped",
          "bytes_rejected", "bytes_duplicate", "bytes_in_flight")


def example_config() -> DVQAEConfig:
    """The example's DVQ-AE (16x16 images)."""
    return DVQAEConfig(kind="image", in_channels=3, hidden=16, latent_dim=16,
                       codebook_size=64, n_res_blocks=1)


def service_kw() -> dict:
    """The service's construction knobs, the same for the crashed and the
    recovered instance."""
    return dict(capacity=6, defer_depth=4,
                decode_policy=BulkDecodePolicy(min_batch=2, max_batch=64,
                                               interval_ticks=2))


class Door:
    """The service as the channel sees it, with every payload offered at
    its admission door and the answer kept: ``audit()`` holds the payloads
    whose words fail their integrity check to the door's answers."""

    def __init__(self, service):
        self.service = service
        self.offers: list = []

    def offer(self, payload, **kw):
        res = self.service.offer(payload, **kw)
        self.offers.append((payload, bool(kw.get("dropped")), res))
        return res

    def __getattr__(self, name):
        return getattr(self.service, name)

    def audit(self) -> dict:
        """{answer: count} of the offers whose words fail ``verify()``
        (radio drops excluded: they never reach the door's checks)."""
        answers: dict = {}
        for p, dropped, res in self.offers:
            if not dropped and not p.verify():
                k = f"{res.verdict}/{res.reason}"
                answers[k] = answers.get(k, 0) + 1
        return answers


class Chaos(NamedTuple):
    """One journaled faulted service and what drives it."""
    service: ContinuousIngestService
    door: Door
    chan: FaultyChannel
    sched: RoundScheduler
    engine: CohortEngine
    data_fn: object
    persist: Optional[ServerPersistence]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def ledger_balances(q) -> bool:
    return q.bytes_sent == (q.bytes_delivered + q.bytes_dropped
                            + q.bytes_rejected + q.bytes_duplicate
                            + q.bytes_in_flight)


def build(cfg: DVQAEConfig, server: OC.ServerState, data: LabeledData, *,
          root: Optional[str], n_slots: int = N_SLOTS, cohort: int = COHORT,
          rate: float = 6.0, capacity_samples: int = 4096,
          device=None) -> Chaos:
    """The example's service around ``server`` (used as given, on
    ``device``): a 2-shard store bounded at ``capacity_samples`` a
    partition, journaled under ``root`` (None: no journal), behind a
    FaultyChannel with the example's plan, key and retries, and a Poisson
    scheduler over ``n_slots`` slots whose clients send ``cohort`` images
    each from their skewed shard of ``data``."""
    dev = resolve_device(device)
    stacked = partition_stacked(data, n_slots, regime="skewed", skew=0.2)
    x = stacked.x[:, :cohort].to(dev)

    def data_fn(ids):
        return x[torch.as_tensor(np.asarray(ids) % n_slots, device=dev)]

    persist = None if root is None else \
        ServerPersistence(root, snapshot_every=SNAPSHOT_EVERY)
    wire = OctopusServer(server, cfg, device=dev,
                         store=ShardedCodeStore(
                             cfg, n_shards=2,
                             capacity_samples=capacity_samples))
    service = ContinuousIngestService(wire, persist=persist, **service_kw())
    door = Door(service)
    chan = FaultyChannel(door, PLAN, key=CHANNEL_KEY,
                         retry=RetryPolicy(max_attempts=3))
    sched = RoundScheduler(
        n_slots,
        SchedulerConfig(rate=rate, straggler_prob=0.4, max_delay=2,
                        drop_prob=0.1, leave_prob=0.2, join_prob=0.5),
        key=SCHED_KEY)
    engine = CohortEngine(cfg, gamma=0.95, n_local_steps=0)
    return Chaos(service, door, chan, sched, engine, data_fn, persist)


def soak(c: Chaos, chan: FaultyChannel, *, cohort: int, ticks: int):
    """``ticks`` faulted ticks through ``chan``: merges every 4 ticks, each
    opening a rolling keep-policy migration window."""
    return c.engine.run_continuous(chan, c.sched, c.data_fn,
                                   cohort_size=cohort, n_ticks=ticks,
                                   merge_every=MERGE_EVERY,
                                   migration_policy="keep")


def recovered_equals_crashed(crashed, recovered) -> None:
    """The recovered service against the crashed one: tick, verdicts,
    verdict bytes, the six ledger fields, store length, latest version,
    the open window and bit-identical decoded features."""
    checks = [("tick", crashed.tick_idx, recovered.tick_idx),
              ("verdicts", crashed.verdicts, recovered.verdicts),
              ("verdict_bytes", crashed.verdict_bytes,
               recovered.verdict_bytes),
              ("store records", len(crashed.wire.store),
               len(recovered.wire.store)),
              ("latest version", crashed.wire.registry.latest,
               recovered.wire.registry.latest),
              ("migration window", crashed.wire.registry.migration,
               recovered.wire.registry.migration)]
    checks += [(a, getattr(crashed.queue, a), getattr(recovered.queue, a))
               for a in LEDGER]
    for what, a, b in checks:
        if a != b:
            raise AssertionError(f"recovered {what} {b} != crashed {a}")
    fa, _ = crashed.wire.features()
    fb, _ = recovered.wire.features()
    if not torch.equal(fa, fb):
        raise AssertionError("recovered features differ from the crashed "
                             "service's")


def run(cfg: Optional[DVQAEConfig] = None, *, device=None, seed: int = 0,
        n_slots: int = N_SLOTS, cohort: int = COHORT, ticks: int = TICKS,
        after: Optional[int] = None, n_images: int = 640, size: int = 16,
        pretrain_steps: int = 40, rate: float = 6.0,
        capacity_samples: int = 4096, root: Optional[str] = None,
        server: Optional[OC.ServerState] = None,
        data: Optional[LabeledData] = None) -> dict:
    """The drill once: soak ``ticks`` faulted ticks, kill, recover, then
    ``after`` (default ``ticks // 2``) more faulted ticks on the recovered
    service and a drain. ``server`` / ``data`` reuse a pretrained server
    (used as given) and a dataset; otherwise both come from ``seed``.
    ``root`` is the service directory (default: a fresh temporary one,
    removed at the end). Returns the figures and the objects."""
    cfg = example_config() if cfg is None else cfg
    dev = resolve_device(device)
    after = ticks // 2 if after is None else after
    rec = obs.install_from_env()                 # OCTOPUS_TRACE=... records
    if data is None:
        data = make_images(torch.Generator().manual_seed(seed), n_images,
                           size=size, n_identities=4)
    if server is None:
        server = pretrained(cfg, data, seed=seed, steps=pretrain_steps,
                            device=dev)
    kw = dict(n_slots=n_slots, cohort=cohort, ticks=ticks, after=after,
              rate=rate, capacity_samples=capacity_samples)
    if root is not None:
        return _drill(cfg, dev, server, data, root, rec, **kw)
    with tempfile.TemporaryDirectory(prefix="octopus_chaos_") as tmp:
        out = _drill(cfg, dev, server, data, os.path.join(tmp, "srv"), rec,
                     **kw)
        out["recovered"]._persist.journal.close()
        return out


def _drill(cfg, dev, server, data, root, rec, *, n_slots, cohort, ticks,
           after, rate, capacity_samples) -> dict:
    c = build(cfg, server, data, root=root, n_slots=n_slots, cohort=cohort,
              rate=rate, capacity_samples=capacity_samples, device=dev)
    service, chan = c.service, c.chan

    # phase 1: the chaos soak, all of it journaled
    _sync(dev)
    t0 = time.perf_counter()
    hist = soak(c, chan, cohort=cohort, ticks=ticks)
    _sync(dev)
    soak_s = max(time.perf_counter() - t0, 1e-9)
    n_up = sum(service.verdicts.values())
    print(f"\n{ticks} faulted ticks, {n_up} offers, "
          f"{n_up / soak_s:.1f} uplinks/sec under chaos "
          f"({sum(chan.faults.values())} faults injected: "
          + ", ".join(f"{k}={v}" for k, v in sorted(chan.faults.items()))
          + f", {chan.retries} retries)")
    if not ledger_balances(service.queue):
        raise AssertionError("the byte ledger does not balance under chaos")
    print("byte ledger conserved under chaos: OK")

    # phase 2: the CRASH -- abandon the live service (in-flight queue, open
    # migration window and all) and recover from snapshot + journal
    crashed = service
    win = crashed.wire.registry.migration
    if win is None:
        raise AssertionError("the kill was supposed to land mid-migration")
    print(f"\nKILL at tick {crashed.tick_idx} (migration v{win.src}->"
          f"v{win.dst} OPEN, {len(crashed.queue)} payloads in flight)")
    kill = {"tick": crashed.tick_idx, "in_flight": len(crashed.queue),
            "window": list(win), "store_records": len(crashed.wire.store),
            "store_versions": len(crashed.wire.store.versions),
            "decode_dispatches": crashed.decode_dispatches}
    journal = {"entries": c.persist.journal.position,
               "bytes": os.path.getsize(c.persist.journal.path)}
    c.persist.journal.close()            # the killed process's handle
    _sync(dev)
    t0 = time.perf_counter()
    recovered = ContinuousIngestService.recover(root, cfg, None, device=dev,
                                                **service_kw())
    _sync(dev)
    recover_s = time.perf_counter() - t0
    kill["recovered_decode_dispatches"] = recovered.decode_dispatches
    recovered_equals_crashed(crashed, recovered)
    print(f"recovered in {recover_s:.2f}s: verdicts, ledger and decoded "
          f"features EXACT (tick {recovered.tick_idx}, migration window "
          f"still open, {len(recovered.wire.store)} records)")

    # phase 3: the recovered service keeps serving the same chaos
    door2 = Door(recovered)
    chan2 = FaultyChannel(door2, PLAN, key=RECOVERED_KEY,
                          retry=RetryPolicy(max_attempts=3))
    hist2 = soak(c, chan2, cohort=cohort, ticks=after)
    chan2.drain()
    if not ledger_balances(recovered.queue):
        raise AssertionError("the byte ledger does not balance after "
                             "recovery")
    print(f"\npost-recovery: {after} more faulted ticks "
          f"({sum(chan2.faults.values())} faults), ledger still conserved, "
          f"registry at v{recovered.wire.registry.latest}")

    store = recovered.wire.store
    for r in store.records:
        if not r.packed.verify():
            raise AssertionError(f"a stored record of round {r.round} "
                                 f"fails its integrity check")
        now = OC.codes_to_features(cfg, r.packed,
                                   recovered.wire.registry.get(r.version))
        ref = recovered.wire.decode(r.packed)
        if not torch.equal(now.reshape(ref.shape), ref):
            raise AssertionError(f"version {r.version} decodes differently")
    print(f"bit-exact decode for versions {store.versions} after crash + "
          f"recovery: OK")

    door = {"soak": c.door.audit(), "after": door2.audit()}
    refused = {k: v for d in door.values() for k, v in d.items()}
    if any(not k.startswith(("rejected/corrupt", "duplicate/")) for k in
           refused):
        raise AssertionError(f"a corrupted or truncated payload was "
                             f"answered {refused}")
    print(f"corrupted or truncated payloads at the door: "
          + (", ".join(f"{k}={v}" for k, v in sorted(refused.items()))
             or "none"))

    if rec is not None:
        obs.uninstall()
        rec.close()
        print(f"\ntrace written: {rec.path}")
    return {"chaos": c, "crashed": crashed, "recovered": recovered,
            "chan2": chan2, "door2": door2, "history": hist,
            "history_after": hist2, "soak_seconds": soak_s,
            "uplinks": n_up, "uplinks_per_s": n_up / soak_s,
            "faults": dict(chan.faults), "faults_after": dict(chan2.faults),
            "retries": chan.retries + chan2.retries,
            "recover_seconds": recover_s,
            "recovery": dict(recovered.recovery), "journal": journal,
            "kill": kill, "door": door}


def decode_dispatches(out: dict) -> int:
    """The decode dispatches ``run`` made, from the host's own records:
    the crashed service's background batches, the replay's, both
    services' features() at the kill (one a version group), the recovered
    service's batches after it, and the two decodes a record of the final
    check."""
    kill, rec = out["kill"], out["recovered"]
    return (kill["decode_dispatches"]
            + out["recovery"]["decode_dispatches_replayed"]
            + 2 * kill["store_versions"]
            + rec.decode_dispatches - kill["recovered_decode_dispatches"]
            + 2 * len(rec.wire.store))


def encode_dispatches(out: dict) -> int:
    """One fused encode a cohort dispatched: retries and duplicates re-send
    the payload, they do not re-encode."""
    return sum(h.n_cohorts for h in out["history"] + out["history_after"])


if __name__ == "__main__":
    run()
