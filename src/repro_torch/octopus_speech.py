"""Speech scenario on the port (§2.1's motivating example): phoneme content
against speaker style.

    PYTHONPATH=src python -m repro_torch.octopus_speech

The PyTorch copy of ``examples/octopus_speech.py``, with the same steps and
printed lines, on ``cuda`` (``run(cfg, device="cpu")`` runs it on the CPU).
Its ``__main__`` runs the speech DVQ-AE at full width: ``DVQAEConfig(kind=
"speech", in_channels=16, n_groups=8, n_slices=2)`` (hidden 128, M 64, K
256, 2 residual blocks, 3-bit GSVQ codes) on 64-frame clips of 16 channels
from 8 speakers. Clients transmit phoneme-bearing GSVQ codes; IN + VQ
filter the speaker; a §3.3 style transformation reconstructs clips with a
perturbed private component.

Data, weights and every minibatch come from ``seed``; the reference draws
with ``jax.random``, so the two print other figures.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.core.disentangle import perturb_private, recombine
from repro_torch.core.downstream import LinearProbe, accuracy, sgd_train
from repro_torch.core.dvqae import DVQAEConfig, decode, forward
from repro_torch.data.federated import train_test_split
from repro_torch.data.synthetic import N_PHONEMES, make_speech
from repro_torch.privacy.audit import evaluate_adversary, train_adversary
from repro_torch.wire.session import OctopusServer

N_SPEAKERS = 8
FRAMES, CHANNELS = 64, 16


def run(cfg: DVQAEConfig, *, device=None, seed: int = 0, n_clips: int = 600,
        pretrain_steps: int = 250, probe_steps: int = 250,
        audit_steps: int = 200) -> dict:
    """Run the scenario once and return its figures: the recon loss of
    every pretraining step, the uplink payload's shape and bytes, the
    phoneme accuracy on codes, the speaker re-identification audit and
    the anonymised reconstruction's distortion; ``server`` is the
    :class:`OctopusServer` that ingested the training clips."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    data = make_speech(g, n_clips, frames=FRAMES, channels=CHANNELS,
                       n_speakers=N_SPEAKERS)
    train, test = train_test_split(data, 0.2)

    # server pretrain (the paper notes speech codebooks align with phonemes)
    srv = OctopusServer.init(seed, cfg, device=dev)
    train_x = train.x.to(dev)
    recon = []
    for _ in range(pretrain_steps):       # one step a call: the loss curve
        recon.append(srv.pretrain(g, train_x, steps=1).recon_loss)
    recon = torch.stack(recon).tolist() if recon else []
    if recon:
        print(f"recon loss {recon[-1]:.4f}")

    # wire session: one CodePayload uplink, one server-side decode
    client = srv.deploy()
    payload = client.transmit(train.x, labels=train.content)
    srv.ingest(payload)
    raw = int(train.x.numel()) * 4
    print(f"GSVQ codes: {payload.shape}, {payload.nbytes:,} bytes "
          f"({raw / payload.nbytes:.0f}x smaller than raw)")

    feats, label_dict = srv.features()
    probe = LinearProbe(int(feats[0].numel()), N_PHONEMES,
                        generator=g).to(dev)
    sgd_train(g, probe, feats, label_dict["label"], steps=probe_steps)
    te_feats = srv.decode(client.transmit(test.x))
    acc = accuracy(probe, te_feats, test.content.to(dev))
    print(f"phoneme accuracy on codes: {acc:.3f}")

    adv = train_adversary(g, te_feats, test.style, N_SPEAKERS,
                          steps=audit_steps)
    m = evaluate_adversary(adv, te_feats, test.style, N_SPEAKERS)
    print(f"speaker re-identification: acc={m.accuracy:.3f} "
          f"H(Y|Z)={m.conditional_entropy_bits:.2f} bits")

    # ---- §3.3 style transformation: reconstruct with perturbed private part
    x4 = test.x[:4].to(dev)
    with torch.no_grad():
        out = forward(srv.state.params, cfg, x4)
        z_anon = recombine(out.latent.public,
                           perturb_private(g, out.latent.private, scale=1.0))
        recon_anon = decode(srv.state.params, cfg, z_anon)
    distortion = float((recon_anon - x4).square().mean())
    print(f"anonymized reconstruction shape: {tuple(recon_anon.shape)}; "
          f"distortion vs original: {distortion:.4f}")
    return {"recon_losses": recon, "payload_shape": tuple(payload.shape),
            "uplink_bytes": payload.nbytes, "raw_bytes": raw,
            "phoneme_accuracy": acc, "reid_accuracy": m.accuracy,
            "reid_entropy_bits": m.conditional_entropy_bits,
            "anon_shape": tuple(recon_anon.shape),
            "anon_distortion": distortion,
            "n_train": int(train.x.shape[0]),
            "n_test": int(test.x.shape[0]), "server": srv}


if __name__ == "__main__":
    run(DVQAEConfig(kind="speech", in_channels=CHANNELS, n_groups=8,
                    n_slices=2))
