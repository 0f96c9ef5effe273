"""Non-IID federated splits (§3.1 settings).

Port of the split part of ``repro.data.federated``. The permutations come
from ``numpy.random.default_rng(seed)``, as the reference's do, so the
port's shards hold the same samples in the same order. Regimes:
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
