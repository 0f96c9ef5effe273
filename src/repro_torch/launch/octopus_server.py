"""Async code-server launch entry: scheduler scenarios over the runtime.

Port of ``repro.launch.octopus_server``. Pretrains a global DVQ-AE,
replays one (or every) ``STANDARD_SCENARIOS`` traffic profile through
``AsyncCodeServer``, then trains the content and style heads from one
decode of the versioned store. Prints each scenario's rounds/sec, measured
uplink bytes, store and version state and task accuracies.

    python -m repro_torch.launch.octopus_server \\
        [--scenario full|partial|churn|adversary|all] [--slots 8] \\
        [--rounds 8] [--smoke] [--device cuda|cpu]
    PYTHONPATH=src python -m repro_torch.launch.octopus_server --smoke \\
        --device cpu

It runs on cuda unless ``--device cpu`` is given, at the full-width
``DVQAEConfig()`` on 32x32x3 images; ``--smoke`` takes the reference's
small model (hidden 16, M 16, 16x16 images) and its CI knobs. Data,
weights and minibatches come from ``--seed``; the reference draws with
``jax.random``, so the two print other figures. The scheduler's keys are
the reference's (``fold_in(PRNGKey(seed), index)``), so the event streams
are the same.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.core import octopus as OC
from repro_torch.core.dvqae import DVQAEConfig
from repro_torch.data.federated import partition_stacked, stacked_batches
from repro_torch.data.synthetic import make_images
from repro_torch.server import (STANDARD_SCENARIOS, AsyncCodeServer,
                                MultiTaskTrainer, RoundScheduler, TaskSpec)
from repro_torch.server.scheduler import _fold_in, _prng_key
from repro_torch.sim import SimEngine


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_scenario(name, scenario, *, engine, server, stacked, slots, rounds,
                 local_batch, probe_steps, seed: int = 0, index: int = 0,
                 verbose: bool = True, device=None):
    """Drive one traffic scenario through the runtime, then train the two
    standard heads from one store decode -> (srv, acc, rounds_per_sec).
    Round 0 is the warm-up; rounds/sec is timed over the rest."""
    if rounds < 2:
        raise ValueError("need rounds >= 2: round 0 is the warm-up, "
                         "rounds/sec is timed over the rest")
    dev = resolve_device(device)
    sched = RoundScheduler(slots, scenario.sched,
                           key=_fold_in(_prng_key(seed), index))
    srv = AsyncCodeServer(engine, server, sched,
                          merge_every=scenario.merge_every,
                          staleness_decay=0.5, device=dev)
    t0 = time.time()
    for r, b in zip(range(rounds),
                    stacked_batches(stacked, local_batch, seed=seed,
                                    epochs=rounds)):
        if r == 1:
            _sync(dev)
            t0 = time.time()                    # round 0 is the warm-up
        srv.run_round(b.x, labels={"content": b.content, "style": b.style})
    _sync(dev)
    rps = (rounds - 1) / max(time.time() - t0, 1e-9)

    feats, labels = srv.dataset()
    tasks = [TaskSpec("content", int(stacked.content.max()) + 1),
             TaskSpec("style", int(stacked.style.max()) + 1)]
    g = torch.Generator().manual_seed(seed + index)
    trainer = MultiTaskTrainer(g, tasks, int(feats[0].numel()), device=dev)
    trainer.fit(g, feats, labels, steps=probe_steps, batch=64)
    acc = trainer.accuracy(feats, labels)
    if verbose:
        print(f"[{name}] {rps:.2f} rounds/sec | bytes sent={srv.bytes_sent} "
              f"delivered={srv.bytes_delivered} "
              f"dropped={srv.bytes_dropped} | "
              f"store {len(srv.store)} recs v{list(srv.store.versions)} "
              f"({srv.n_merges} merges) | "
              + " ".join(f"{t}={a:.3f}" for t, a in acc.items()))
    return srv, acc, rps


def prepare(cfg: DVQAEConfig, *, slots: int, rounds: int, local_batch: int,
            pretrain_steps: int, seed: int = 0, size: int = 32,
            device=None):
    """Data, a pretrained server and the engine the scenarios share ->
    (server, stacked, engine, last pretraining recon loss)."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    data = make_images(g, max(slots * local_batch * rounds, slots * 16),
                       size=size, n_identities=4)
    server, out = OC.server_pretrain(g, OC.server_init(seed, cfg, device=dev),
                                     cfg, data.x.to(dev),
                                     steps=pretrain_steps)
    stacked = partition_stacked(data, slots, regime="skewed", skew=0.2)
    stacked = stacked._replace(**{f: getattr(stacked, f).to(dev)
                                  for f in stacked._fields})
    recon = None if out is None else float(out.recon_loss)
    return server, stacked, SimEngine(cfg, lr=1e-4, gamma=0.95), recon


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="all",
                    choices=sorted(STANDARD_SCENARIOS) + ["all"])
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--local-batch", type=int, default=8)
    ap.add_argument("--codebook", type=int, default=None,
                    help="codebook size (the config's own by default)")
    ap.add_argument("--probe-steps", type=int, default=150)
    ap.add_argument("--pretrain-steps", type=int, default=80)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    size = 32
    cfg = DVQAEConfig()
    if args.smoke:
        args.slots, args.rounds, args.local_batch = 4, 4, 4
        args.probe_steps, args.pretrain_steps = 20, 20
        size = 16
        cfg = DVQAEConfig(kind="image", in_channels=3, hidden=16,
                          latent_dim=16, codebook_size=64, n_res_blocks=1)
    if args.codebook is not None:
        cfg = cfg.replace(codebook_size=args.codebook)

    dev = resolve_device(args.device)
    server, stacked, engine, recon = prepare(
        cfg, slots=args.slots, rounds=args.rounds,
        local_batch=args.local_batch, pretrain_steps=args.pretrain_steps,
        seed=args.seed, size=size, device=dev)
    if recon is not None:
        print(f"pretrain recon loss: {recon:.4f}")
    names = sorted(STANDARD_SCENARIOS) if args.scenario == "all" \
        else [args.scenario]
    out = {}
    for i, name in enumerate(names):
        out[name] = run_scenario(
            name, STANDARD_SCENARIOS[name], engine=engine, server=server,
            stacked=stacked, slots=args.slots, rounds=args.rounds,
            local_batch=args.local_batch, probe_steps=args.probe_steps,
            seed=args.seed, index=i, device=dev)
    return out


if __name__ == "__main__":
    main()
