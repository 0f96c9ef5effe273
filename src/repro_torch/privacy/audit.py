"""Privacy evaluation: the computational adversary (§2.7.2, Theorem 1).

Port of ``repro.privacy.audit``. A classifier q(Y | Z) is trained post hoc
on released components; its test cross-entropy is the (upper-bound
estimate of) conditional entropy H(Y | Z) in bits, and its test accuracy
is the re-identification rate. The adversary is never part of OCTOPUS
training, only of its evaluation. Random draws come from explicit
``torch.Generator``s.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.downstream import LinearProbe, sgd_train, xent_loss


class AdversaryMetrics(NamedTuple):
    accuracy: float                  # re-identification accuracy
    conditional_entropy_bits: float  # H(Y|Z) estimate via Thm. 1
    loss: float


def init_adversary(generator: Optional[torch.Generator], in_dim: int,
                   n_classes: int, hidden: int = 256) -> nn.Module:
    """3-layer MLP probe on flattened features (the reference's dense
    equivalent of the paper's 3 Conv1d + FC)."""
    return LinearProbe(in_dim, n_classes, hidden=hidden, generator=generator)


def adversary_logits(params: nn.Module, z: torch.Tensor) -> torch.Tensor:
    return params(_flatten_features(z))


def xent(params: nn.Module, z: torch.Tensor, y: torch.Tensor
         ) -> torch.Tensor:
    return xent_loss(params, _flatten_features(z), y)


def _flatten_features(z: torch.Tensor) -> torch.Tensor:
    return z.reshape(z.shape[0], -1).float()


def train_adversary(generator: torch.Generator, features: torch.Tensor,
                    labels, n_classes: int, *, steps: int = 300,
                    lr: float = 1e-3, batch: int = 256) -> nn.Module:
    """Fit q(Y|Z) by AdamW on cross-entropy (the Thm. 1 bound minimizer)."""
    z = _flatten_features(features)
    head = init_adversary(generator, z.shape[-1], n_classes).to(z.device)
    return sgd_train(generator, head, z, labels, steps=steps, lr=lr,
                     batch=batch)


@torch.no_grad()
def evaluate_adversary(params: nn.Module, features: torch.Tensor, labels,
                       n_classes: int) -> AdversaryMetrics:
    """Test-set CE -> conditional entropy in bits (Thm. 1); accuracy."""
    logits = adversary_logits(params, features)
    labels = torch.as_tensor(labels, device=logits.device).long()
    nll = -F.log_softmax(logits, -1).gather(1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return AdversaryMetrics(accuracy=float(acc),
                            conditional_entropy_bits=float(nll) / math.log(2),
                            loss=float(nll))


def privacy_audit(generator: torch.Generator, public_feats: torch.Tensor,
                  private_feats: torch.Tensor, labels, n_classes: int,
                  steps: int = 300
                  ) -> Tuple[AdversaryMetrics, AdversaryMetrics]:
    """Paired audit: an adversary on Z• (want: high H, low accuracy) and
    one on Z∘ (expected: low H, high accuracy).

    Samples are permuted before the 80/20 split: features arrive
    label-sorted from non-IID partitions, and an unshuffled split would
    test the adversary on classes it never saw.
    """
    labels = torch.as_tensor(labels, device=public_feats.device)
    n = labels.shape[0]
    # the private component broadcasts over positions; tile to the samples
    pf = private_feats.expand((n,) + tuple(private_feats.shape[1:])) \
        if private_feats.shape[0] != n else private_feats
    perm = torch.randperm(n, generator=generator).to(labels.device)
    public_feats, pf, labels = public_feats[perm], pf[perm], labels[perm]
    split = int(0.8 * n)
    pub = train_adversary(generator, public_feats[:split], labels[:split],
                          n_classes, steps=steps)
    pub_m = evaluate_adversary(pub, public_feats[split:], labels[split:],
                               n_classes)
    prv = train_adversary(generator, pf[:split], labels[:split], n_classes,
                          steps=steps)
    prv_m = evaluate_adversary(prv, pf[split:], labels[split:], n_classes)
    return pub_m, prv_m
