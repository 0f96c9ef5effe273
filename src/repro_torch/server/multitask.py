"""Multi-task downstream training from ONE shared code store (Step 6).

Port of ``repro.server.multitask``. Clients upload codes once and the
server trains any number of downstream heads on them: every head (the
paper's 3-linear-layer probe, :class:`~repro_torch.core.downstream.
LinearProbe`) trains from one bulk decode of the store, and every step
updates EVERY head on the same shared minibatch (the summed loss; the
heads' parameters are disjoint, so each gets exactly its own gradient)
with one AdamW state over all heads.

The reference draws its minibatches with ``jax.random.randint`` and seeds
head ``i`` with ``fold_in(key, i)``; the port takes a ``torch.Generator``
for both, so a one-task trainer reproduces
:func:`~repro_torch.core.downstream.sgd_train` exactly. Heads from the
reference come across through ``convert.probe_from_numpy``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.core import downstream as DS
from repro_torch.optim.adamw import adamw_init, adamw_update, leaves


class TaskSpec(NamedTuple):
    name: str                 # label key in the store / labels dict
    n_classes: int


class MultiTaskTrainer:
    """N probe heads over shared features, one step for all of them.
    Heads are drawn in task order from ``generator`` and live on
    ``device`` (cuda unless ``device="cpu"``)."""

    def __init__(self, generator: torch.Generator, tasks: Sequence[TaskSpec],
                 in_dim: int, *, hidden: int = 128, lr: float = 1e-3,
                 device=None):
        if not tasks:
            raise ValueError("need at least one task")
        names = [t.name for t in tasks]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate task names: {names}")
        dev = resolve_device(device)
        self.tasks = tuple(tasks)
        self.in_dim = int(in_dim)
        self.lr = lr
        self.params: Dict[str, DS.LinearProbe] = {
            t.name: DS.LinearProbe(self.in_dim, t.n_classes, hidden,
                                   generator=generator).to(dev)
            for t in tasks}
        self._opt = adamw_init(self._heads())

    def _heads(self):
        return [self.params[t.name] for t in self.tasks]

    def step(self, xb: torch.Tensor, ys: Dict[str, torch.Tensor]) -> None:
        """One AdamW step of every head on the shared minibatch ``xb``."""
        heads = self._heads()
        params = leaves(heads)
        with torch.enable_grad():
            for p in params:
                p.requires_grad_(True)
            loss = sum(DS.xent_loss(self.params[t.name], xb, ys[t.name])
                       for t in self.tasks)
            grads = torch.autograd.grad(loss, params)
        _, self._opt = adamw_update(heads, grads, self._opt, lr=self.lr)

    # ------------------------------------------------------------- train

    def fit(self, generator: torch.Generator, feats, labels, *,
            steps: int = 200, batch: int = 64):
        """Train every head on the shared decoded features; minibatch rows
        drawn with replacement from ``generator``, as ``sgd_train`` does."""
        missing = [t.name for t in self.tasks if t.name not in labels]
        if missing:
            raise ValueError(f"labels missing for tasks {missing}; "
                             f"store carries {sorted(labels)}")
        feats = feats.reshape(feats.shape[0], -1)
        ys = {t.name: torch.as_tensor(labels[t.name], device=feats.device)
              for t in self.tasks}
        n = feats.shape[0]
        for _ in range(steps):
            sel = torch.randint(0, n, (min(batch, n),), generator=generator) \
                .to(feats.device)
            self.step(feats[sel], {k: y[sel] for k, y in ys.items()})
        return self.params

    def fit_from_store(self, generator: torch.Generator, store, server=None,
                       *, registry=None, version=None, steps: int = 200,
                       batch: int = 64):
        """Decode the store ONCE, then train all heads from the shared
        features. ``store`` is a ``CodeStore`` (with ``server`` /
        ``registry``) or an ``OctopusServer`` (its version-correct
        ``features()``). Returns (params, feats, labels)."""
        if hasattr(store, "features"):          # wire endpoint
            feats, labels = store.features(version=version)
        else:
            feats, labels = store.dataset(server, registry=registry,
                                          version=version)
        self.fit(generator, feats, labels, steps=steps, batch=batch)
        return self.params, feats, labels

    # -------------------------------------------------------------- eval

    def accuracy(self, feats, labels) -> Dict[str, float]:
        feats = feats.reshape(feats.shape[0], -1)
        return {t.name: DS.accuracy(self.params[t.name], feats,
                                    labels[t.name])
                for t in self.tasks}
