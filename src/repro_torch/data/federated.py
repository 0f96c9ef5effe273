"""Non-IID federated splits (§3.1 settings) and minibatch iterators.

Port of ``repro.data.federated``. The permutations come from
``numpy.random.default_rng(seed)``, as the reference's do, so the port's
shards and batches hold the same samples in the same order. Regimes:
  * iid     — uniform random assignment (the paper's best case)
  * worst   — sorted by label, each client gets a single class
  * skewed  — fraction ``skew`` assigned by label, the rest uniform
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .synthetic import LabeledData


def _take(data: LabeledData, idx) -> LabeledData:
    idx = torch.as_tensor(np.asarray(idx, np.int64))
    return LabeledData(x=data.x[idx], content=data.content[idx],
                       style=data.style[idx])


def partition(data: LabeledData, n_clients: int, *, regime: str = "iid",
              skew: float = 0.2, seed: int = 0) -> List[LabeledData]:
    """Per-client shards of ``data``."""
    n = int(data.content.shape[0])
    rng = np.random.default_rng(seed)
    labels = data.content.cpu().numpy()
    if regime == "iid":
        perm = rng.permutation(n)
    elif regime == "worst":
        perm = np.argsort(labels, kind="stable")
    elif regime == "skewed":
        n_sorted = int(n * skew)
        sel = rng.permutation(n)
        sorted_part = sel[:n_sorted][np.argsort(labels[sel[:n_sorted]],
                                                kind="stable")]
        rest = rng.permutation(sel[n_sorted:])
        perm = np.concatenate([sorted_part, rest])
    else:
        raise ValueError(regime)
    return [_take(data, s) for s in np.array_split(perm, n_clients)]


def partition_stacked(data: LabeledData, n_clients: int, *,
                      regime: str = "iid", skew: float = 0.2,
                      seed: int = 0) -> LabeledData:
    """Equal-size client shards stacked on a leading client axis: fields
    (n_clients, n_per, ...), the layout the sim engine takes. Shards are cut
    to the smallest shard's size, which drops at most n_clients - 1
    samples."""
    shards = partition(data, n_clients, regime=regime, skew=skew, seed=seed)
    n_per = min(int(s.x.shape[0]) for s in shards)
    return LabeledData(*(torch.stack([getattr(s, f)[:n_per] for s in shards])
                         for f in LabeledData._fields))


def stacked_batches(stacked: LabeledData, batch_size: int, *, seed: int = 0,
                    epochs: int = 1):
    """Per-client shuffled minibatches over a :func:`partition_stacked`
    layout: LabeledData with (n_clients, batch_size, ...) fields, one
    round's local data for every client, each epoch a fresh permutation of
    every client's shard."""
    C, n = int(stacked.x.shape[0]), int(stacked.x.shape[1])
    rng = np.random.default_rng(seed)
    rows = torch.arange(C)[:, None]
    for _ in range(epochs):
        perms = np.stack([rng.permutation(n) for _ in range(C)])  # (C, n)
        for i in range(0, n - batch_size + 1, batch_size):
            sel = torch.as_tensor(perms[:, i:i + batch_size])      # (C, B)
            yield LabeledData(*(f[rows.to(f.device), sel.to(f.device)]
                                for f in stacked))


def train_test_split(data: LabeledData, test_frac: float = 0.2,
                     seed: int = 0):
    n = int(data.content.shape[0])
    perm = np.random.default_rng(seed).permutation(n)
    cut = int(n * (1 - test_frac))
    return _take(data, perm[:cut]), _take(data, perm[cut:])


def holdout_atd(data: LabeledData, atd_frac: float = 0.15, seed: int = 1):
    """§3.1: 15% of Tr held out as the public ATD set for server
    pretraining -> (rest, atd)."""
    n = int(data.content.shape[0])
    perm = np.random.default_rng(seed).permutation(n)
    cut = int(n * atd_frac)
    return _take(data, perm[cut:]), _take(data, perm[:cut])


def batches(data: LabeledData, batch_size: int, *, seed: int = 0,
            epochs: int = 1):
    """Shuffled minibatches of ``data``, a fresh permutation an epoch; a
    last partial batch is dropped."""
    n = int(data.content.shape[0])
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        perm = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            yield _take(data, perm[i:i + batch_size])
