"""Federated baselines the paper compares against (§3.1): FedAvg
[McMahan'17], FedProx [Li'18], DP-FL [Geyer'17 style clip+noise], and the
data-sharing strategy [Zhao'18].

Port of ``repro.core.fedavg`` over a classifier ``nn.Module`` (the conv
baseline :class:`~repro_torch.core.downstream.ConvClassifier`) and the
port's AdamW. A client's local pass trains a copy of the global module and
returns the parameter delta, leaf by leaf in ``parameters()`` order.

Random draws come from CPU ``torch.Generator`` s, one stream per (round,
client) and one per (round, client, 999) for the DP noise, each seeded by
``np.random.SeedSequence((seed, round, client[, 999]))`` (the reference
folds those numbers into a ``jax.random`` key, which torch cannot
reproduce). So a client's update depends only on the seed, the round, its
index and its data: :func:`fedavg_train_batched` over equal-size shards
gives :func:`fedavg_train`'s result bit for bit.
"""
from __future__ import annotations

import copy
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.data.synthetic import LabeledData
from repro_torch.optim.adamw import (adamw_init, adamw_update,
                                     clip_by_global_norm)

from .downstream import xent_loss


class FedConfig(NamedTuple):
    rounds: int = 20
    local_epochs: int = 1
    local_batch: int = 32
    lr: float = 1e-3
    # FedProx proximal coefficient (0 = plain FedAvg)
    prox_mu: float = 0.0
    # client-level DP: clip + gaussian noise on the update
    dp_clip: float = 0.0
    dp_noise: float = 0.0


def client_generator(seed: int, *path: int) -> torch.Generator:
    """The CPU generator of one (round, client[, purpose]) stream."""
    state = np.random.SeedSequence([int(seed), *map(int, path)]) \
        .generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def _local_update(generator: torch.Generator, model: nn.Module,
                  x: torch.Tensor, y: torch.Tensor, n_steps: int,
                  fc: FedConfig) -> List[torch.Tensor]:
    """One client's local training pass from the global ``model`` (left
    untouched): ``n_steps`` AdamW steps on minibatches of ``min(local_batch,
    n)`` rows drawn with replacement from ``generator``, the FedProx term
    ``prox_mu/2 * ||p - p_global||^2`` added when ``prox_mu``. Returns the
    delta, one tensor a parameter."""
    local = copy.deepcopy(model)
    params = list(local.parameters())
    glob = [p.detach() for p in model.parameters()]
    opt = adamw_init(params)
    n = x.shape[0]
    bsz = min(fc.local_batch, n)
    for _ in range(n_steps):
        sel = torch.randint(0, n, (bsz,), generator=generator).to(x.device)
        loss = xent_loss(local, x[sel], y[sel])
        if fc.prox_mu:
            sq = sum((a - b).square().sum() for a, b in zip(params, glob))
            loss = loss + 0.5 * fc.prox_mu * sq
        grads = torch.autograd.grad(loss, params)
        _, opt = adamw_update(params, grads, opt, lr=fc.lr)
    return [a.detach() - b for a, b in zip(params, glob)]


def _privatize_delta(generator: torch.Generator, delta, fc: FedConfig
                     ) -> List[torch.Tensor]:
    """DP-FL: clip the delta to global norm ``dp_clip``, then add
    N(0, (dp_noise * dp_clip)^2) noise drawn leaf by leaf from
    ``generator``. Identity when ``dp_clip`` is 0."""
    if not fc.dp_clip:
        return list(delta)
    delta, _ = clip_by_global_norm(delta, fc.dp_clip)
    return [d + fc.dp_noise * fc.dp_clip
            * torch.randn(d.shape, generator=generator).to(d.device)
            for d in delta]


def _aggregate(deltas: Sequence[List[torch.Tensor]], weights
               ) -> List[torch.Tensor]:
    """FedAvg aggregation: ``sum_c w_c * delta_c`` leaf by leaf, clients
    summed in order (float32 weights)."""
    return [sum(w * d for w, d in zip(weights, ds)) for ds in zip(*deltas)]


def _train(seed: int, model: nn.Module, clients, fc: FedConfig, dev
           ) -> nn.Module:
    """``fc.rounds`` FedAvg rounds over ``clients`` [(x, y), ...] from a
    copy of ``model`` on ``dev``; deltas weighted by shard size."""
    glob = copy.deepcopy(model).to(dev)
    clients = [(torch.as_tensor(x, device=dev),
                torch.as_tensor(y, device=dev)) for x, y in clients]
    sizes = np.asarray([x.shape[0] for x, _ in clients], np.float32)
    weights = sizes / sizes.sum()
    for r in range(fc.rounds):
        deltas = []
        for ci, (x, y) in enumerate(clients):
            steps = max(1, fc.local_epochs * x.shape[0] // fc.local_batch)
            d = _local_update(client_generator(seed, r, ci), glob, x, y,
                              steps, fc)
            deltas.append(_privatize_delta(
                client_generator(seed, r, ci, 999), d, fc))
        with torch.no_grad():
            for p, a in zip(glob.parameters(), _aggregate(deltas, weights)):
                p.add_(a)
    return glob


def fedavg_train(seed: int, model: nn.Module,
                 shards: Sequence[LabeledData], label_fn: Callable,
                 fc: FedConfig = FedConfig(),
                 shared_data: Optional[LabeledData] = None, *,
                 device=None) -> nn.Module:
    """Run federated rounds on ``device`` (cuda unless ``device="cpu"``);
    returns the final global model, a copy (``model`` is not changed).

    ``shared_data`` implements the Zhao'18 data-sharing mitigation: a
    small public set appended to every client shard."""
    if shared_data is not None:
        shards = [LabeledData(*(torch.cat([a, b.to(a.device)])
                                for a, b in zip(s, shared_data)))
                  for s in shards]
    return _train(seed, model, [(s.x, label_fn(s)) for s in shards], fc,
                  resolve_device(device))


def fedavg_train_batched(seed: int, model: nn.Module, xs, ys,
                         fc: FedConfig = FedConfig(), *,
                         device=None) -> nn.Module:
    """FedAvg over equal-size client shards stacked on a leading client
    axis: xs (C, n, ...), ys (C, n) (``data.federated.partition_stacked``).
    The clients' passes run one after another over the stack, with the
    same per-client streams as :func:`fedavg_train`, so the two give the
    same model bit for bit."""
    return _train(seed, model, [(xs[c], ys[c]) for c in range(xs.shape[0])],
                  fc, resolve_device(device))
