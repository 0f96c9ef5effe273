"""Federation with temporal drift on the sim engine (§2.6).

    PYTHONPATH=src python -m repro_torch.federated_sync

The PyTorch copy of ``examples/federated_sync.py``, with the same steps,
sizes and printed lines, on the full-width ``DVQAEConfig()`` (the example
runs hidden 32, M 16, K 128) and on ``cuda`` (``run(cfg, device="cpu")``
runs it on the CPU). Clients see a distribution shift mid-stream; instead
of retraining, each refreshes its codebook by EMA (Eq. 9) on the new data,
and the server merges the codebooks count-weighted (Step 5). Every round's
uplink is the measured bit-packed payload (§2.8). Recon quality recovers
without touching the encoder or decoder weights.

Data, weights and every minibatch come from ``seed``; the reference draws
with ``jax.random``, so the two print other figures.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.core import octopus as OC
from repro_torch.core.dvqae import DVQAEConfig, forward
from repro_torch.data.federated import partition_stacked
from repro_torch.data.synthetic import make_images
from repro_torch.sim.engine import SimEngine, unstack_clients

N_CLIENTS = 4


@torch.no_grad()
def mean_recon(clients: OC.ClientState, cfg: DVQAEConfig,
               x: torch.Tensor) -> float:
    """Mean over clients of each client's recon loss on its own batch."""
    losses = [forward(c.params, cfg, x[i]).recon_loss
              for i, c in enumerate(unstack_clients(clients))]
    return float(torch.stack(losses).mean())


def run(cfg: DVQAEConfig, *, device=None, seed: int = 0,
        n_images: int = 400, pretrain_steps: int = 250,
        per_client: int = 64, rounds: int = 20) -> dict:
    """Run the drift scenario once and return its figures: the last
    pretraining step's recon loss, the recon on drifted data before and
    after the refresh rounds and with the merged dictionary, and the
    measured uplink bytes."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)

    # phase-1 data and a drifted phase 2 (brighter, shifted styles)
    d1 = make_images(g, n_images, size=32, n_identities=8)
    d2_raw = make_images(g, n_images, size=32, n_identities=8)
    d2 = d2_raw._replace(x=d2_raw.x * 1.6 + 0.8)

    server = OC.server_init(seed, cfg, device=dev)
    server, out = OC.server_pretrain(g, server, cfg, d1.x.to(dev),
                                     steps=pretrain_steps, batch=32)
    pretrain = float(out.recon_loss) if out is not None else None
    if pretrain is not None:
        print(f"phase-1 recon loss: {pretrain:.4f}")

    # Step 2 deployment: the clients as one stacked population; phase-2
    # shards stacked (C, n, ...) so the population advances per round
    shards2 = partition_stacked(d2, N_CLIENTS, regime="worst")
    x2 = shards2.x[:, :per_client].to(dev)                # (C, 64, H, W, 3)

    # n_local_steps=0: refresh-only rounds, the codebook EMA alone absorbs
    # the drift, with NO gradient training
    engine = SimEngine(cfg, gamma=0.9, n_local_steps=0)
    clients = engine.init_clients(server, N_CLIENTS)
    drifted = mean_recon(clients, cfg, x2)
    print(f"recon on drifted phase-2 data BEFORE codebook refresh: "
          f"{drifted:.4f}")

    uplink, packed = 0, None
    for _ in range(rounds):
        clients, packed = engine.round(clients, x2)
        uplink += packed.nbytes
    after = mean_recon(clients, cfg, x2)
    print(f"recon AFTER {rounds} EMA refreshes (no gradient training): "
          f"{after:.4f}")
    raw = rounds * x2.numel() * 4
    if packed is not None:
        print(f"measured uplink: {uplink} bytes over {rounds} rounds "
              f"({packed.bits} bits/code, raw would be {raw} bytes)")

    server = engine.merge_into_server(server, clients)
    merged = mean_recon(engine.init_clients(server, N_CLIENTS), cfg, x2)
    print(f"recon with the MERGED global dictionary: {merged:.4f}")
    print(f"improvement from pure codebook updates: "
          f"{(drifted - after) / drifted * 100:.1f}%")
    return {"pretrain_recon": pretrain, "recon_before": drifted,
            "recon_after": after, "recon_merged": merged,
            "uplink_bytes": uplink, "raw_bytes": raw,
            "bits": None if packed is None else packed.bits}


if __name__ == "__main__":
    run(DVQAEConfig())
