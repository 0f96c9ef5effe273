"""Continuous-ingest server runtime end to end (Step 6 as a service).

    PYTHONPATH=src python -m repro_torch.octopus_async

The PyTorch copy of ``examples/octopus_async.py``, with the same steps,
knobs and printed lines, on the full-width ``DVQAEConfig()`` at 32x32x3
and on ``cuda`` (``run(cfg, device="cpu")`` runs it on the CPU). A Poisson
``RoundScheduler`` emits open-ended client arrivals (stragglers, radio
drops, churn); every uplink is a ``CodePayload`` offered through admission
control and answered with a verdict; admitted payloads flow through a
bounded queue into a ``(codebook version, client shard)``-partitioned
``ShardedCodeStore``; Step 5 merges happen mid-stream and open rolling
migration windows, so payloads of both versions ingest while the registry
keeps every snapshot for bit-exact decode; background bulk decodes
amortize the decode kernel; and a ``MultiTaskTrainer`` fits a content and
a style head from ONE decode of the surviving store.

Set ``OCTOPUS_TRACE=trace.jsonl`` to flight-record the run, then audit it
with ``python -m repro_torch.obs.report trace.jsonl --check`` (or the
reference's ``repro.obs.report``). Data, weights and minibatches come from
``seed``; the scheduler's key is the example's (``PRNGKey(7)``), so the
arrival stream is the reference's.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.core import octopus as OC
from repro_torch.core.dvqae import DVQAEConfig
from repro_torch.data.federated import partition_stacked
from repro_torch.data.synthetic import LabeledData, make_images
from repro_torch.server import (BulkDecodePolicy, ContinuousIngestService,
                                MultiTaskTrainer, RoundScheduler,
                                SchedulerConfig, ShardedCodeStore, TaskSpec)
from repro_torch.sim import CohortEngine
from repro_torch.wire.session import OctopusServer

N_SLOTS, COHORT, TICKS = 16, 4, 24
SCHED_KEY = 7


class Service(NamedTuple):
    """Everything one soak drives: the wire endpoint, the service in front
    of it, the scheduler, the cohort engine and the data callbacks."""
    wire: OctopusServer
    service: ContinuousIngestService
    sched: RoundScheduler
    engine: CohortEngine
    data_fn: object
    labels_fn: object
    stacked: LabeledData


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def pretrained(cfg: DVQAEConfig, data: LabeledData, *, seed: int,
               steps: int, device) -> OC.ServerState:
    """Step 1: the global DVQ-AE pretrained on ``data`` (batch 32)."""
    g = torch.Generator().manual_seed(seed)
    server, out = OC.server_pretrain(
        g, OC.server_init(seed, cfg, device=device), cfg,
        data.x.to(device), steps=steps)
    if out is not None:
        print(f"pretrain recon loss: {float(out.recon_loss):.4f}")
    return server


def build(cfg: DVQAEConfig, server: OC.ServerState, data: LabeledData, *,
          n_slots: int = N_SLOTS, cohort: int = COHORT, rate: float = 6.0,
          capacity_samples: int = 2048, device=None) -> Service:
    """The example's service around ``server`` (used as given, on
    ``device``): a deliberately tight queue (3 payloads, deferring past 2)
    so bursts hit backpressure, a 4-shard store bounding memory per
    (version, shard), a bulk-decode policy, and a Poisson scheduler over
    ``n_slots`` slots whose clients send ``cohort`` images each from their
    skewed shard of ``data`` (the example ties a client's images to the
    cohort size)."""
    dev = resolve_device(device)
    stacked = partition_stacked(data, n_slots, regime="skewed", skew=0.2)
    stacked = LabeledData(*(f[:, :cohort].to(dev) for f in stacked))

    def data_fn(ids):
        return stacked.x[torch.as_tensor(np.asarray(ids) % n_slots,
                                         device=dev)]

    def labels_fn(ids):
        sel = torch.as_tensor(np.asarray(ids) % n_slots, device=dev)
        return {"content": stacked.content[sel],
                "style": stacked.style[sel]}

    wire = OctopusServer(server, cfg, device=dev,
                         store=ShardedCodeStore(
                             cfg, n_shards=4,
                             capacity_samples=capacity_samples))
    service = ContinuousIngestService(
        wire, capacity=3, defer_depth=2,
        decode_policy=BulkDecodePolicy(min_batch=2, max_batch=64,
                                       interval_ticks=2))
    sched = RoundScheduler(
        n_slots,
        SchedulerConfig(rate=rate, straggler_prob=0.4, max_delay=2,
                        drop_prob=0.1, leave_prob=0.2, join_prob=0.5),
        key=SCHED_KEY)
    engine = CohortEngine(cfg, gamma=0.95, n_local_steps=0)
    return Service(wire, service, sched, engine, data_fn, labels_fn,
                   stacked)


def soak(s: Service, *, cohort: int, ticks: int, merge_every: int = 0,
         migration_policy: Optional[str] = None):
    """``ticks`` ticks of continuous traffic through the service."""
    return s.engine.run_continuous(
        s.service, s.sched, s.data_fn, cohort_size=cohort, n_ticks=ticks,
        merge_every=merge_every, labels_fn=s.labels_fn,
        migration_policy=migration_policy)


def run(cfg: DVQAEConfig, *, device=None, seed: int = 0,
        n_slots: int = N_SLOTS, cohort: int = COHORT, ticks: int = TICKS,
        n_images: int = 640, size: int = 32, pretrain_steps: int = 80,
        rate: float = 6.0, capacity_samples: int = 2048,
        probe_steps: int = 150, final_policy: Optional[str] = None,
        server: Optional[OC.ServerState] = None,
        data: Optional[LabeledData] = None) -> dict:
    """Run the soak once and return its figures and its objects.

    ``server`` / ``data`` reuse a pretrained server (used as given) and a
    dataset; otherwise both are drawn from ``seed``. ``final_policy``
    closes the last window under that migration policy after the drain
    (``"reencode"`` transcodes the previous version's records to the
    latest dictionary); None leaves the example's open keep window."""
    dev = resolve_device(device)
    rec = obs.install_from_env()                 # OCTOPUS_TRACE=... records
    if data is None:
        data = make_images(torch.Generator().manual_seed(seed), n_images,
                           size=size, n_identities=4)
    if server is None:
        server = pretrained(cfg, data, seed=seed, steps=pretrain_steps,
                            device=dev)
    s = build(cfg, server, data, n_slots=n_slots, cohort=cohort, rate=rate,
              capacity_samples=capacity_samples, device=dev)
    srv, service = s.wire, s.service

    # one warm-up tick, then the soak: merges every 6 ticks, each opening
    # a rolling keep-policy migration window
    warm = soak(s, cohort=cohort, ticks=1)
    warm_verdicts = sum(service.verdicts.values())
    _sync(dev)
    t0 = time.time()
    hist = soak(s, cohort=cohort, ticks=ticks, merge_every=6,
                migration_policy="keep")
    _sync(dev)
    t_ticks = time.time() - t0
    service.drain()
    _sync(dev)
    dt = max(time.time() - t0, 1e-9)

    n_up = sum(service.verdicts.values()) - warm_verdicts
    print(f"\n{ticks} ticks, {sum(t.n_participants for t in hist)} arrivals, "
          f"{n_up / dt:.1f} uplinks/sec sustained (post-warm-up)")
    print("admission verdicts: "
          + ", ".join(f"{v}={service.verdicts.get(v, 0)}"
                      for v in ("accepted", "migrated", "deferred",
                                "rejected")))

    q = service.queue
    print(f"uplink bytes: sent={q.bytes_sent} delivered={q.bytes_delivered} "
          f"dropped={q.bytes_dropped} rejected={q.bytes_rejected} "
          f"duplicate={q.bytes_duplicate} in_flight={q.bytes_in_flight}")
    if q.bytes_sent != (q.bytes_delivered + q.bytes_dropped
                        + q.bytes_rejected + q.bytes_duplicate
                        + q.bytes_in_flight):
        raise AssertionError("the byte ledger does not balance")
    print("byte ledger conserved across refusals: OK")

    progress, sources = None, ()
    if final_policy is not None and srv.registry.latest > 0:
        if srv.registry.migration is not None:
            service.complete_migration()
        win = service.begin_migration(policy=final_policy)
        sources = tuple(r for r in srv.store.records if r.version == win.src)
        progress = service.complete_migration()
        print(f"final {final_policy} window v{progress['src']}->"
              f"v{progress['dst']}: {progress['n_reencoded']} records "
              f"re-encoded")

    store = srv.store
    print(f"store: {len(store)} records / {store.n_samples} samples across "
          f"{len(store.partitions)} (version, shard) partitions, "
          f"evicted={store.evicted_records} records "
          f"({store.evicted_bytes}B stay ledgered)")
    print(f"registry: latest v{srv.registry.latest}, "
          f"{srv.registry.latest} rolling migrations completed, "
          f"decode amortization {service.decode_amortization:.2f} "
          f"records/dispatch")

    # every surviving record still decodes against the snapshot it was
    # packed under, bit-exact across all the mid-stream merges
    for r in store.records:
        now = OC.codes_to_features(cfg, r.packed, srv.registry.get(r.version))
        ref = srv.decode(r.packed)
        if not torch.equal(now.reshape(ref.shape), ref):
            raise AssertionError(f"version {r.version} decodes differently")
    print(f"bit-exact decode for versions {store.versions}: OK")

    # Step 6: TWO downstream heads from ONE decode of the shared store
    feats, labels = srv.features()
    tasks = [TaskSpec("content", int(s.stacked.content.max()) + 1),
             TaskSpec("style", int(s.stacked.style.max()) + 1)]
    g = torch.Generator().manual_seed(seed)
    trainer = MultiTaskTrainer(g, tasks, int(feats[0].numel()), device=dev)
    trainer.fit(g, feats, labels, steps=probe_steps, batch=64)
    acc = trainer.accuracy(feats, labels)
    print("multi-task from one decode: "
          + ", ".join(f"{t}={a:.3f}" for t, a in acc.items()))

    if rec is not None:
        obs.uninstall()
        rec.close()
        print(f"flight recording written to {rec.path}")
    return {"service": s, "warmup": warm, "history": hist, "seconds": dt,
            "tick_seconds": t_ticks, "uplinks": n_up,
            "uplinks_per_s": n_up / dt, "ticks_per_s": ticks / dt,
            "verdicts": dict(service.verdicts),
            "verdict_bytes": dict(service.verdict_bytes),
            "final_migration": progress, "reencoded_from": sources,
            "accuracy": acc, "n_features": int(feats.shape[0])}


if __name__ == "__main__":
    run(DVQAEConfig())
