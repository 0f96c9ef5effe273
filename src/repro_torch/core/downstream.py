"""Downstream models (§3.1.1, §3.6): a small conv classifier on raw
images or speech (the centralized/federated baseline) and a linear probe
on decoded OCTOPUS features.

Port of ``repro.core.downstream``: both models as ``nn.Module``s, their
training (:func:`sgd_train`, AdamW on cross-entropy) and :func:`accuracy`.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.nn.layers import Conv1d, Conv2d, dense_init


class ConvClassifier(nn.Module):
    """The conv baseline: two stride-2 SAME convs (k 3) with ReLU, global
    average pooling, a dense layer with ReLU and a head. ``kind="image"``
    takes (B, H, W, C) images, ``kind="speech"`` (B, T, C) frames; dense
    weights are (in, out), used as ``x @ w``."""

    def __init__(self, in_channels: int, n_classes: int, hidden: int = 32,
                 kind: str = "image", *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if kind not in ("image", "speech"):
            raise ValueError(f"kind must be image or speech, got {kind!r}")
        g = generator
        conv = Conv2d if kind == "image" else Conv1d
        self.kind = kind
        self.c1 = conv(in_channels, hidden, 3, generator=g)
        self.c2 = conv(hidden, hidden * 2, 3, generator=g)
        self.w = nn.Parameter(dense_init(hidden * 2, hidden * 2, generator=g))
        self.b = nn.Parameter(torch.zeros(hidden * 2))
        self.head = nn.Parameter(dense_init(hidden * 2, n_classes,
                                            generator=g))
        self.hb = nn.Parameter(torch.zeros(n_classes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.movedim(-1, 1)                          # channels first
        h = F.relu(self.c1(h, stride=2))
        h = F.relu(self.c2(h, stride=2))
        h = h.mean(dim=tuple(range(2, h.ndim)))       # GAP
        h = F.relu(h @ self.w + self.b)
        return h @ self.head + self.hb


class LinearProbe(nn.Module):
    """The latent-code head: three linear layers with ReLU between. The
    weights are (in, out) and used as ``x @ w``, as in the reference."""

    def __init__(self, in_dim: int, n_classes: int, hidden: int = 128, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.w1 = nn.Parameter(dense_init(in_dim, hidden, generator=g))
        self.b1 = nn.Parameter(torch.zeros(hidden))
        self.w2 = nn.Parameter(dense_init(hidden, hidden, generator=g))
        self.b2 = nn.Parameter(torch.zeros(hidden))
        self.w3 = nn.Parameter(dense_init(hidden, n_classes, generator=g))
        self.b3 = nn.Parameter(torch.zeros(n_classes))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        z = z.reshape(z.shape[0], -1)
        h = F.relu(z @ self.w1 + self.b1)
        h = F.relu(h @ self.w2 + self.b2)
        return h @ self.w3 + self.b3


def xent_loss(head: nn.Module, x: torch.Tensor, y: torch.Tensor
              ) -> torch.Tensor:
    """Mean cross-entropy of the head's logits against int labels."""
    logp = F.log_softmax(head(x), dim=-1)
    return -logp.gather(1, y.long()[:, None]).mean()


def sgd_train(generator: torch.Generator, head: nn.Module, x: torch.Tensor,
              y, *, steps: int = 200, lr: float = 1e-3,
              batch: int = 64) -> nn.Module:
    """``steps`` AdamW steps on minibatches of (x, y) drawn with
    replacement from ``generator``; trains ``head`` in place and returns
    it."""
    from repro_torch.optim.adamw import adamw_init, adamw_update
    y = torch.as_tensor(y, device=x.device)
    params = list(head.parameters())
    opt = adamw_init(params)
    n = x.shape[0]
    for _ in range(steps):
        sel = torch.randint(0, n, (min(batch, n),), generator=generator) \
            .to(x.device)
        grads = torch.autograd.grad(xent_loss(head, x[sel], y[sel]), params)
        _, opt = adamw_update(params, grads, opt, lr=lr)
    return head


@torch.no_grad()
def accuracy(head: nn.Module, x: torch.Tensor, y) -> float:
    """Share of rows whose argmax logit is the label."""
    logits = head(x)
    y = torch.as_tensor(y, device=logits.device)
    return float((logits.argmax(-1) == y).float().mean())
