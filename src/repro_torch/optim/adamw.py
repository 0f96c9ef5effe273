"""AdamW over lists or dicts of tensors, with global-norm clipping.

Port of ``repro.optim.adamw``, with its constants: ``b1=0.9``,
``b2=0.95``, ``eps=1e-8`` added outside the square root, and
``weight_decay=0``. These are not ``torch.optim.AdamW``'s defaults.

A parameter tree is a tensor, an ``nn.Module`` (its parameters), or a
list, tuple or dict of trees; its leaves are taken in order.
:func:`adamw_update` updates the parameters and the moments IN PLACE
(the reference returns new arrays) and returns them with the new state.
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch
from torch import nn


class AdamWState(NamedTuple):
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    count: int


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a parameter tree, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        tree = tree.values()
    return [t for sub in tree for t in leaves(sub)]


def adamw_init(params) -> AdamWState:
    zeros = [torch.zeros_like(p, dtype=torch.float32) for p in leaves(params)]
    return AdamWState(mu=zeros, nu=[torch.zeros_like(z) for z in zeros],
                      count=0)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(l.float().square().sum() for l in leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """-> (list of scaled gradients, their global norm before scaling)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return [g * scale for g in leaves(grads)], norm


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *, lr: float,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.0, grad_clip: float = 0.0):
    """One AdamW step -> (params, state); ``params`` and the moments are
    updated in place. The bias corrections are float32, as the
    reference's ``1 - b ** count`` of a float32 count is."""
    flat_g = leaves(grads)
    if grad_clip:
        flat_g, _ = clip_by_global_norm(flat_g, grad_clip)
    count = state.count + 1
    cf = torch.tensor(float(count), dtype=torch.float32)
    bc1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** cf)
    bc2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** cf)
    flat_p = leaves(params)
    flat_g = [g.float() for g in flat_g]
    mu, nu = state.mu, state.nu
    # one multi-tensor launch per line instead of one per leaf
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, flat_g, alpha=1 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, flat_g, flat_g, value=1 - b2)
    den = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    step = torch._foreach_div(mu, bc1)
    torch._foreach_div_(step, den)
    if weight_decay:
        torch._foreach_add_(step, [p.float() for p in flat_p],
                            alpha=weight_decay)
    torch._foreach_sub_(flat_p, torch._foreach_mul(step, lr))
    return params, AdamWState(mu=mu, nu=nu, count=count)
