"""Cohort-streamed population engine at 100k-client scale (§2.2).

    PYTHONPATH=src python -m repro_torch.population_engine

The PyTorch copy of ``examples/population_engine.py``, with its config,
counts and checks, on ``cuda`` (``run(cfg, device="cpu")`` runs it on the
CPU). A ``CohortEngine`` streams a round through fixed-size cohorts (one
fused ``encode_codes`` a cohort, peak memory one cohort's state), so one
host runs a 102,400-client round. The run shows the three contracts:

  1. grouping invariance: the cohort-streamed round reproduces the one-shot
     population round bit for bit (int64 ``MergeStats``, payload words, Σ
     bytes) at 4,096 clients against cohorts of 512;
  2. §2.8 accounting: Σ per-cohort ``nbytes`` equals the population
     round's measured bytes;
  3. traffic realism: a diurnal ``RoundScheduler`` breathes the per-round
     cohort count day and night, payloads stream into
     ``OctopusServer.ingest`` over the shared ``UplinkQueue``, and every
     merge registers a codebook version.

Every client reads its own row of a shared pool (slot id modulo the pool's
4,096 rows), so any grouping sees the same per-client batches. The pool
and the weights come from ``seed``; the scheduler's key is the example's
(7), so the traffic's event stream is the reference's. Set
``OCTOPUS_TRACE=trace.jsonl`` to flight-record the run;
``OCTOPUS_BENCH_QUICK=1`` (or ``quick=True``) cuts the population round
to 8,192 clients.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.core import octopus as OC
from repro_torch.core.dvqae import DVQAEConfig
from repro_torch.server import (DiurnalProfile, RoundScheduler,
                                SchedulerConfig)
from repro_torch.sim import CohortEngine, CohortPlan
from repro_torch.wire.payload import concat_payloads
from repro_torch.wire.session import OctopusServer

POOL_ROWS = 4096
PARITY_CLIENTS, PARITY_COHORT = 4096, 512
N_CLIENTS, QUICK_CLIENTS, COHORT = 102_400, 8_192, 1024
TRAFFIC_SLOTS, TRAFFIC_COHORT, ROUNDS, MERGE_EVERY = 8192, 512, 6, 3
SCHED_KEY = 7


def example_config() -> DVQAEConfig:
    """The example's DVQ-AE (8x8 images, 256 atoms)."""
    return DVQAEConfig(kind="image", in_channels=3, hidden=8, latent_dim=8,
                       codebook_size=256, n_res_blocks=1)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def pool_fn(pool: torch.Tensor):
    """Slot ids -> their rows of ``pool`` (id modulo its rows)."""
    def data_fn(ids):
        return pool[torch.as_tensor(np.asarray(ids) % pool.shape[0],
                                    device=pool.device)]
    return data_fn


def parity(engine: CohortEngine, server: OC.ServerState, data_fn, *,
           n: int = PARITY_CLIENTS, cohort: int = PARITY_COHORT) -> dict:
    """Contracts 1 and 2 at ``n`` clients: one-shot against cohorts of
    ``cohort``; raises if the stats, words or bytes differ."""
    full = engine.round(server, CohortPlan.from_groups([np.arange(n)]),
                        data_fn)
    parts = engine.round(server, CohortPlan.build(np.arange(n), cohort),
                         data_fn)
    cat = concat_payloads(parts.payloads)
    if not (torch.equal(parts.stats.num, full.stats.num)
            and torch.equal(parts.stats.den, full.stats.den)):
        raise AssertionError("streamed MergeStats differ from the one-shot "
                             "round's")
    if not torch.equal(cat.payload, full.payloads[0].payload):
        raise AssertionError("concatenated cohort words differ from the "
                             "one-shot payload")
    if parts.nbytes != full.nbytes:
        raise AssertionError(f"cohort bytes {parts.nbytes} != one-shot "
                             f"bytes {full.nbytes}")
    print(f"parity @ {n} clients: streamed round bit-matches one-shot round "
          f"({parts.nbytes} uplink bytes either way)")
    return {"full": full, "parts": parts,
            "n_cohorts": 1 + len(parts.payloads)}


def run(cfg: Optional[DVQAEConfig] = None, *, device=None, seed: int = 0,
        size: int = 8, quick: Optional[bool] = None,
        n_clients: Optional[int] = None, parity_clients: int = PARITY_CLIENTS,
        parity_cohort: int = PARITY_COHORT, cohort: int = COHORT,
        traffic_slots: int = TRAFFIC_SLOTS,
        traffic_cohort: int = TRAFFIC_COHORT,
        server: Optional[OC.ServerState] = None, pool=None) -> dict:
    """Run the three parts once and return their figures and objects.

    ``n_clients`` overrides the population round's size (default 102,400,
    or 8,192 under ``quick`` / ``OCTOPUS_BENCH_QUICK=1``). The traffic's
    scheduler quantizes participation to ``traffic_cohort`` clients (the
    example's 512 for both). ``server`` is used as given; otherwise it is
    drawn from ``seed``, untrained, as in the example. ``pool`` (rows, 1,
    size, size, channels) replaces the pool drawn from ``seed``."""
    cfg = example_config() if cfg is None else cfg
    dev = resolve_device(device)
    if quick is None:
        quick = os.environ.get("OCTOPUS_BENCH_QUICK", "") == "1"
    if n_clients is None:
        n_clients = QUICK_CLIENTS if quick else N_CLIENTS
    rec = obs.install_from_env()                 # OCTOPUS_TRACE=... records
    if rec is not None:
        print(f"flight recorder active -> {rec.path}")
    if server is None:
        server = OC.server_init(seed, cfg, device=dev)
    if pool is None:
        pool = torch.randn((POOL_ROWS, 1, size, size, cfg.in_channels),
                           generator=torch.Generator().manual_seed(seed))
    data_fn = pool_fn(torch.as_tensor(pool, dtype=torch.float32).to(dev))
    engine = CohortEngine(cfg, gamma=0.99, n_local_steps=0)

    # ---- 1+2: bit-exact cohort parity, then scale to the population
    par = parity(engine, server, data_fn, n=parity_clients,
                 cohort=parity_cohort)
    plan = CohortPlan.build(np.arange(n_clients), cohort)
    engine.round(server, CohortPlan.from_groups([plan.cohorts[0]]),
                 data_fn)                                   # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    out = engine.round(server, plan, data_fn)
    _sync(dev)
    dt = time.perf_counter() - t0
    print(f"population round: {n_clients} clients in {dt:.1f}s "
          f"({n_clients / dt:,.0f} clients/sec, {plan.n_cohorts} cohorts, "
          f"{out.nbytes} uplink bytes)")
    server = OC.server_merge_stats(server, out.stats)       # Step 5 tail

    # ---- 3: diurnal traffic through the wire endpoint
    wire = OctopusServer(server, cfg, device=dev)
    sched = RoundScheduler(
        traffic_slots, SchedulerConfig(participation=0.5, straggler_prob=0.3,
                                       drop_prob=0.05),
        key=SCHED_KEY, profile=DiurnalProfile(period=6, trough=0.25),
        quantum=traffic_cohort)
    _sync(dev)
    t0 = time.perf_counter()
    hist = engine.run_traffic(wire, sched, data_fn,
                              cohort_size=traffic_cohort, n_rounds=ROUNDS,
                              merge_every=MERGE_EVERY)
    _sync(dev)
    traffic_s = time.perf_counter() - t0
    for h in hist:
        print(f"round {h.round}: {h.n_participants:5d} clients in "
              f"{h.n_cohorts} cohorts, sent {h.bytes_sent}B, "
              f"delivered {h.bytes_delivered}B"
              + (f", merged -> v{h.merged_version}" if h.merged_version
                 else ""))
    feats, _ = wire.features()
    print(f"store: {len(wire.store)} payloads across codebook versions, "
          f"{feats.shape[0]} samples decoded version-correctly")
    if rec is not None:
        obs.uninstall()
        rec.close()
        print(f"flight recording written to {rec.path}")
    return {"parity": par, "round": out, "n_clients": n_clients,
            "cohorts": plan.n_cohorts, "round_seconds": dt,
            "clients_per_s": n_clients / dt, "traffic": hist,
            "traffic_seconds": traffic_s, "wire": wire, "engine": engine,
            "data_fn": data_fn,
            "n_features": int(feats.shape[0]),
            "encode_dispatches": par["n_cohorts"] + 1 + plan.n_cohorts
            + sum(h.n_cohorts for h in hist)}


if __name__ == "__main__":
    run()
