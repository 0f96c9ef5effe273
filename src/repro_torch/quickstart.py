"""Quickstart: the OCTOPUS protocol end to end on the port.

    PYTHONPATH=src python -m repro_torch.quickstart

The PyTorch copy of ``examples/quickstart.py``, with the same steps, sizes
and printed lines, on the full-width ``DVQAEConfig()`` and on ``cuda``
(``run(cfg, device="cpu")`` runs it on the CPU):

1. The server pretrains a DVQ-AE on public data (ATD).
2. Worst-case non-IID clients fine-tune locally and transmit ONLY
   discrete latent codes.
3. The server trains a downstream probe on the gathered codes.
4. A privacy audit shows identity (style) is filtered while content
   classification survives.

Data, weights and every minibatch come from ``seed``; the reference draws
with ``jax.random``, so the two print other figures.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.core.downstream import LinearProbe, accuracy, sgd_train
from repro_torch.core.dvqae import DVQAEConfig
from repro_torch.data.federated import (holdout_atd, partition,
                                        train_test_split)
from repro_torch.data.synthetic import make_images
from repro_torch.privacy.audit import evaluate_adversary, train_adversary
from repro_torch.wire.session import OctopusServer

N_CLIENTS = 4
N_CLASSES = 8


def run(cfg: DVQAEConfig, *, device=None, seed: int = 0,
        n_images: int = 800, pretrain_steps: int = 200,
        probe_steps: int = 200, audit_steps: int = 200) -> dict:
    """Run the protocol once and return its figures: the recon loss of
    every pretraining step, the uplink and raw bytes, the downstream
    content accuracy and the re-identification audit."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)

    # ---------------------------------------------- data (content x style)
    data = make_images(g, n_images, size=32, n_identities=N_CLASSES)
    train, test = train_test_split(data, 0.2)
    train, atd = holdout_atd(train, 0.15)
    clients = partition(train, N_CLIENTS, regime="worst")
    print(f"{len(clients)} clients, {train.x.shape[0]} train samples, "
          f"{atd.x.shape[0]} public ATD samples")

    # ----------------------------------------------- Step 1: server pretrain
    srv = OctopusServer.init(seed, cfg, device=dev)
    atd_x = atd.x.to(dev)
    recon = []
    for _ in range(pretrain_steps):       # one step a call: the loss curve
        out = srv.pretrain(g, atd_x, steps=1)
        recon.append(out.recon_loss)
    recon = torch.stack(recon).tolist() if recon else []
    if recon:
        print(f"server DVQ-AE pretrained: recon loss {recon[-1]:.4f}")

    # -------------- Steps 2-4: clients fine-tune and transmit CodePayloads
    for ci, shard in enumerate(clients):
        client = srv.deploy(client_id=ci)
        client.finetune(shard.x[:32])
        payload = client.transmit(shard.x, labels=shard.content)
        srv.ingest(payload, client_ids=[ci])
    total_bytes = srv.store.total_bytes              # measured from the wire
    raw_bytes = sum(int(s.x.numel()) * 4 for s in clients)
    print(f"transmitted {total_bytes:,} bytes of codes "
          f"(raw would be {raw_bytes:,}: {raw_bytes / total_bytes:.0f}x "
          f"saving)")

    # ------------------------------------- Step 6: downstream at the server
    feats, label_dict = srv.features()               # ONE bulk decode
    probe = LinearProbe(int(feats[0].numel()), N_CLASSES,
                        generator=g).to(dev)
    sgd_train(g, probe, feats, label_dict["label"], steps=probe_steps)
    te_feats = srv.decode(srv.deploy().transmit(test.x))
    acc = accuracy(probe, te_feats, test.content.to(dev))
    print(f"downstream content accuracy on codes: {acc:.3f}")

    # --------------------------------------------------------- privacy audit
    adv = train_adversary(g, te_feats, test.style, N_CLASSES,
                          steps=audit_steps)
    m = evaluate_adversary(adv, te_feats, test.style, N_CLASSES)
    print(f"identity re-identification from released codes: "
          f"acc={m.accuracy:.3f}, H(Y|Z)={m.conditional_entropy_bits:.2f} "
          f"bits (chance = {1 / N_CLASSES:.3f}, max H = 3 bits)")
    return {"recon_losses": recon, "uplink_bytes": total_bytes,
            "raw_bytes": raw_bytes, "content_accuracy": acc,
            "reid_accuracy": m.accuracy,
            "reid_entropy_bits": m.conditional_entropy_bits,
            "reid_loss": m.loss, "n_train": int(train.x.shape[0]),
            "n_atd": int(atd.x.shape[0]), "n_test": int(test.x.shape[0])}


if __name__ == "__main__":
    run(DVQAEConfig())
