"""Inference attacks on captured code streams (red team for §2.5).

Port of ``repro.privacy.attacks``. The attacker's vantage point is the
packed :class:`~repro_torch.wire.payload.CodePayload` streams a
:class:`~repro_torch.privacy.tap.PayloadTap` records off the wire, not the
decoded latents of ``privacy_audit``. Both attacks are shadow-classifier
attacks over per-sample code histograms (order-free code usage):

  * ATTRIBUTE inference: predict a sensitive per-sample attribute (style,
    speaker, identity) behind a captured payload. A privatized stream
    must score at chance; the leaky control (IN off) must not.
  * MEMBERSHIP inference: decide whether a captured payload's client was
    observed before (each client carries a persistent latent signature,
    so re-identifying the signature IS membership).

``advantage = accuracy - chance``, chance being the majority-class rate of
the held-out split. The split's permutation and the probe's init and
minibatches come from one ``torch.Generator``, in that order (the
reference draws them from ``jax.random`` keys, which torch cannot
reproduce): a report is deterministic in the generator's seed. With a
flight recorder installed, each attack emits an ``attack`` event (scalar
results only).
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Union

import numpy as np
import torch

from repro_torch.obs import recorder as _obs

from .audit import evaluate_adversary, train_adversary
from .tap import PayloadTap, TapRecord


class AttackReport(NamedTuple):
    """One attack's scorecard on a held-out split."""
    attack: str           # "attribute:<name>" | "membership" | caller's
    accuracy: float       # held-out attack accuracy
    chance: float         # majority-class rate of the held-out split
    advantage: float      # accuracy - chance (~0: the attack failed)
    conditional_entropy_bits: float   # Thm. 1 H(Y|Z) estimate
    n_train: int
    n_test: int
    n_classes: int


def _records(source: Union[PayloadTap, Sequence[TapRecord]]
             ) -> List[TapRecord]:
    recs = list(source.records if isinstance(source, PayloadTap)
                else source)
    if not recs:
        raise ValueError("no captured payloads to attack")
    return recs


def payload_histograms(payloads, n_atoms: int) -> torch.Tensor:
    """Captured payloads -> (N_samples, n_atoms) float32 code-usage
    histograms on the payloads' device.

    Each payload unpacks to (C, B, T[, S]) indices; every (client, sample)
    row becomes one histogram over the transmitted alphabet, normalized by
    its code count in float64 and rounded to float32, as the reference's
    numpy does. Codes outside ``range(n_atoms)`` count nowhere.
    """
    rows = []
    for p in payloads:
        idx = p.unpack()
        flat = idx.reshape(idx.shape[0] * idx.shape[1], -1)
        atoms = torch.arange(n_atoms, device=flat.device)
        counts = (flat[..., None] == atoms).sum(dim=1)
        rows.append((counts.double() / flat.shape[1]).float())
    return torch.cat(rows, dim=0)


def sample_labels(records: Sequence[TapRecord], key: str) -> np.ndarray:
    """Per-SAMPLE int32 labels from per-record tap meta: a record's meta
    value may be a scalar (all its samples share it) or an array of one
    label per sample."""
    parts = []
    for r in records:
        n = int(r.payload.shape[0]) * int(r.payload.shape[1])
        v = r.meta.get(key)
        if v is None:
            raise KeyError(f"tap record lacks meta[{key!r}]")
        if isinstance(v, torch.Tensor):
            v = v.cpu().numpy()
        arr = np.asarray(v).reshape(-1)
        if arr.size == 1:
            arr = np.full((n,), int(arr[0]))
        if arr.size != n:
            raise ValueError(f"meta[{key!r}] has {arr.size} labels for "
                             f"{n} samples")
        parts.append(arr.astype(np.int32))
    return np.concatenate(parts, axis=0)


def shadow_attack(generator: torch.Generator, features, labels,
                  n_classes: int, *, attack: str = "attribute",
                  steps: int = 200, train_frac: float = 0.8,
                  test_features=None, test_labels=None) -> AttackReport:
    """Train the Thm. 1 probe as a shadow classifier and score it.

    Default: permute with ``generator`` and split ``train_frac``/rest
    (captured streams arrive client-sorted). ``test_features`` /
    ``test_labels`` replace the split with a disjoint evaluation capture
    (the membership setting). Runs on the features' device; the generator
    is a CPU one.
    """
    feats = torch.as_tensor(features)
    y = torch.as_tensor(labels, device=feats.device).long()
    if test_features is None:
        n = int(y.shape[0])
        perm = torch.randperm(n, generator=generator).to(feats.device)
        feats, y = feats[perm], y[perm]
        split = int(train_frac * n)
        tr_f, tr_y = feats[:split], y[:split]
        te_f, te_y = feats[split:], y[split:]
    else:
        tr_f, tr_y = feats, y
        te_f = torch.as_tensor(test_features, device=feats.device)
        te_y = torch.as_tensor(test_labels, device=feats.device).long()
    params = train_adversary(generator, tr_f, tr_y, n_classes, steps=steps)
    m = evaluate_adversary(params, te_f, te_y, n_classes)
    counts = np.bincount(te_y.cpu().numpy(), minlength=n_classes)
    chance = float(counts.max() / max(1, counts.sum()))
    report = AttackReport(
        attack=attack, accuracy=m.accuracy, chance=chance,
        advantage=m.accuracy - chance,
        conditional_entropy_bits=m.conditional_entropy_bits,
        n_train=int(tr_y.shape[0]), n_test=int(te_y.shape[0]),
        n_classes=int(n_classes))
    rec = _obs.active()
    if rec is not None:
        rec.event("attack", attack=report.attack,
                  accuracy=report.accuracy, chance=report.chance,
                  advantage=report.advantage,
                  n_train=report.n_train, n_test=report.n_test,
                  n_classes=report.n_classes)
        rec.metrics.observe(f"attack_advantage/{report.attack}",
                            report.advantage)
    return report


def attribute_inference(generator: torch.Generator,
                        source: Union[PayloadTap, Sequence[TapRecord]], *,
                        attribute: str, n_classes: int, n_atoms: int,
                        steps: int = 200) -> AttackReport:
    """Predict a sensitive per-sample attribute from captured payloads."""
    recs = _records(source)
    feats = payload_histograms([r.payload for r in recs], n_atoms)
    y = sample_labels(recs, attribute)
    return shadow_attack(generator, feats, y, n_classes,
                         attack=f"attribute:{attribute}", steps=steps)


def membership_inference(generator: torch.Generator,
                         train: Union[PayloadTap, Sequence[TapRecord]],
                         test: Union[PayloadTap, Sequence[TapRecord]], *,
                         n_atoms: int, flag: str = "member",
                         steps: int = 200) -> AttackReport:
    """Decide whether a captured payload's client was previously
    observed. ``train`` is the attacker's shadow capture (its own
    member/non-member ground truth in ``meta[flag]``); ``test`` is a
    later, disjoint capture of the same population plus fresh clients.
    """
    tr = _records(train)
    te = _records(test)
    tr_f = payload_histograms([r.payload for r in tr], n_atoms)
    te_f = payload_histograms([r.payload for r in te], n_atoms)
    return shadow_attack(generator, tr_f, sample_labels(tr, flag), 2,
                         attack="membership", steps=steps,
                         test_features=te_f,
                         test_labels=sample_labels(te, flag))
