"""AdamW over lists or dicts of tensors, with global-norm clipping.

Port of ``repro.optim.adamw``, with its constants: ``b1=0.9``,
``b2=0.95``, ``eps=1e-8`` added outside the square root, and
``weight_decay=0``. These are not ``torch.optim.AdamW``'s defaults.

A parameter tree is a tensor, an ``nn.Module`` (its parameters), or a
list, tuple or dict of trees; its leaves are taken in order.
:func:`adamw_update` updates the parameters and the moments IN PLACE
(the reference returns new arrays) and returns them with the new state.
It walks the leaves in groups of about :data:`GROUP_BYTES`, so that its
temporaries (the clipped gradient, the denominator and the step) are a
group's, not the whole tree's: at Jamba's first two layers (3.74 B
parameters, 13.9 GiB a copy) three whole-tree copies would not fit one
card beside the parameters, gradients and moments. Every operation is
elementwise, so the grouping changes no bit.

On a device mesh the leaves are DTensors: a group holds leaves of one
layout (the ``_foreach_`` ops take one at a time), a gradient is laid out
as its parameter before the update, the moments keep their parameter's
layout (``distributed.steps.state_specs``), and the global norm sums every
shard's squares.
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch
from torch import nn

from repro_torch.hints import is_dtensor


#: the bytes of leaves one pass of the update takes at a time (a larger
#: leaf is a group of its own)
GROUP_BYTES = 1 << 30


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


def _square_sum(t: torch.Tensor) -> torch.Tensor:
    """sum(t^2) over the whole tensor (every shard of a DTensor)."""
    s = t.float().square().sum()
    return s.full_tensor() if is_dtensor(s) else s


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(_square_sum(l) for l in leaves(tree)))


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
    reference's ``1 - b ** count`` of a float32 count is; the moments are
    float32 whatever the parameters' type, and a bfloat16 parameter's step
    is rounded to bfloat16 before ``p - lr * step`` is formed in float32 and
    rounded once, as the reference casts it."""
    flat_p = leaves(params)
    flat_g = [g.redistribute(p.device_mesh, p.placements)
              if is_dtensor(g) and g.placements != p.placements else g
              for p, g in zip(flat_p, leaves(grads))]
    scale = None
    if grad_clip:                        # clip_by_global_norm, by group
        norm = global_norm(flat_g)
        scale = torch.clamp(grad_clip / torch.clamp(norm, min=1e-9), max=1.0)
    count = state.count + 1
    cf = torch.tensor(float(count), dtype=torch.float32)
    bc1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** cf)
    bc2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** cf)
    mu, nu = state.mu, state.nu
    for idx in _groups(flat_p):
        p = [flat_p[i] for i in idx]
        g = [flat_g[i].float() for i in idx]
        if scale is not None:
            g = [x * scale for x in g]
        m, v = [mu[i] for i in idx], [nu[i] for i in idx]
        # one multi-tensor launch per line instead of one per leaf
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g, g, value=1 - b2)
        del g
        den = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        step = torch._foreach_div(m, bc1)
        torch._foreach_div_(step, den)
        del den
        if weight_decay:
            torch._foreach_add_(step, [x.float() for x in p],
                                alpha=weight_decay)
        # the reference's p - lr * step.astype(p.dtype) in float32, rounded
        # once to p's type (a float32 step is kept as it is)
        step = [t.to(x.dtype).float() for t, x in zip(step, p)]
        torch._foreach_mul_(step, lr)
        torch._foreach_sub_(p, step)
    return params, AdamWState(mu=mu, nu=nu, count=count)


def _layout(t):
    """A DTensor's (mesh, placements); None for a plain tensor."""
    return (t.device_mesh, t.placements) if is_dtensor(t) else None


def _groups(tensors):
    """Index lists of consecutive leaves of one layout and at most
    GROUP_BYTES each (a larger leaf alone)."""
    group, size, layout = [], 0, None
    for i, t in enumerate(tensors):
        n = t.numel() * t.element_size()
        if group and (size + n > GROUP_BYTES or _layout(t) != layout):
            yield group
            group, size = [], 0
        group.append(i)
        size += n
        layout = _layout(t)
    if group:
        yield group
