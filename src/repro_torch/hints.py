"""Activation-sharding hints.

Port of ``repro.hints``: layout constraints at a few places in the model,
active only under :func:`activation_sharding` (which the mesh step
builders of :mod:`repro_torch.distributed.steps` install), so the model
code stays mesh-agnostic and runs unsharded off a mesh. The reference's
constraint is ``with_sharding_constraint``; the port's is ``redistribute``
of a DTensor to the same spec's placements. A plain tensor, or any tensor
outside a context, passes unchanged. A redistribution that fails raises
(the reference returns its input).

The hints pin (1) batch on the data axes through every residual-stream
tensor, (2) the head axis of q/k/v on 'model' (falling back to the query
sequence when heads don't divide it, and to the head dim at a decode
step).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional, Tuple

from repro_torch.distributed.sharding import P, axis_sizes, to_placements

_CTX = threading.local()


@contextmanager
def activation_sharding(mesh, dp_axes: Tuple[str, ...]):
    prev = getattr(_CTX, "state", None)
    _CTX.state = (mesh, tuple(dp_axes))
    try:
        yield
    finally:
        _CTX.state = prev


def _state():
    return getattr(_CTX, "state", None)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _constrain(x, spec: P):
    st = _state()
    if st is None or not is_dtensor(x):
        return x
    from repro_torch.kernels._mesh import relayout
    return relayout(x, st[0], to_placements(spec, st[0]))


def _dp_for(dim: int) -> Optional[Tuple[str, ...]]:
    st = _state()
    if st is None:
        return None
    mesh, dp = st
    sizes = axis_sizes(mesh)
    size = 1
    for a in dp:
        size *= sizes[a]
    return dp if dim % size == 0 and dim >= size else None


def _model_ok(dim: int) -> bool:
    st = _state()
    if st is None:
        return False
    m = axis_sizes(st[0]).get("model", 1)
    return dim % m == 0 and dim >= m


def split_heads(x, heads: int):
    """(..., heads * D) -> (..., heads, D). A DTensor whose last dim is
    sharded over ranks that ``heads`` does not divide among is first
    gathered on those mesh dims (the reference's reshape leaves that to
    XLA)."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate
        last = x.ndim - 1
        dims = [i for i, p in enumerate(x.placements) if p.is_shard(last)]
        size = 1
        for i in dims:
            size *= x.device_mesh.size(i)
        if dims and heads % size:
            x = x.redistribute(x.device_mesh, tuple(
                Replicate() if i in dims else p
                for i, p in enumerate(x.placements)))
    return x.reshape(*x.shape[:-1], heads, x.shape[-1] // heads)


def settle(x):
    """``x`` as it is, its gradient laid out as ``x`` itself before it
    goes further back. Behind the vocab-sharded embedding gather (whose
    output is a masked partial sum) a partial gradient cannot be turned
    into that partial kind; this makes it whole first."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x.to_local(grad_placements=x.placements),
                              x.device_mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def write_slot(cache, index: int, new) -> None:
    """``cache[:, index:index + T] = new`` in place (a decode step's
    keys or latents into their positions). On a DTensor cache each rank
    writes the positions it holds, ``new`` laid out as the cache first:
    a cache sharded on its sequence dim holds a range of positions."""
    T = new.shape[1]
    if not is_dtensor(cache):
        cache[:, index:index + T] = new
        return
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.kernels._mesh import _as_dtensor, relayout
    mesh, pl = cache.device_mesh, cache.placements
    src = relayout(_as_dtensor(new, mesh), mesh, tuple(
        Replicate() if p.is_shard(1) else p for p in pl)).to_local()
    local = cache.to_local()
    shape, offset = compute_local_shape_and_global_offset(
        tuple(cache.shape), mesh, pl)
    lo, n = offset[1], shape[1]
    a, b = max(index, lo), min(index + T, lo + n)
    if a < b:
        local[:, a - lo:b - lo] = src[:, a - index:b - index]


def residual(x):
    """(B, T, d): batch on data axes, d replicated (residual stream)."""
    if _state() is None:
        return x
    return _constrain(x, P(_dp_for(x.shape[0]), None, None))


def heads(x):
    """(B, T, H, D): batch on data, heads on model.

    When heads don't divide the model axis, the query sequence goes on it
    (context parallelism), not the head dim; a decode step (T == 1) keeps
    the head-dim fallback. The flash kernel counts query positions from a
    shard's start, so :func:`repro_torch.kernels.ops.flash_attention`
    gathers such a q to whole rows first."""
    if _state() is None:
        return x
    dp = _dp_for(x.shape[0])
    if _model_ok(x.shape[2]):
        return _constrain(x, P(dp, None, "model", None))
    if x.shape[1] > 1 and _model_ok(x.shape[1]):
        return _constrain(x, P(dp, "model", None, None))
    if _model_ok(x.shape[3]):
        return _constrain(x, P(dp, None, None, "model"))
    return _constrain(x, P(dp, None, None, None))


def kv_heads(x):
    """(B, T, Hkv, D) keys/values: H on model if divisible, else
    replicated."""
    if _state() is None:
        return x
    dp = _dp_for(x.shape[0])
    if _model_ok(x.shape[2]):
        return _constrain(x, P(dp, None, "model", None))
    return _constrain(x, P(dp, None, None, None))


def ffn_hidden(x):
    """(B, T, d_ff): the column-parallel intermediate — d_ff on model."""
    if _state() is None:
        return x
    dp = _dp_for(x.shape[0])
    if _model_ok(x.shape[-1]):
        return _constrain(x, P(dp, None, "model"))
    return _constrain(x, P(dp, None, None))


def logits(x):
    """(B, T, V) or (B, V): vocab on model."""
    if _state() is None:
        return x
    spec = [_dp_for(x.shape[0])] + [None] * (x.ndim - 1)
    if _model_ok(x.shape[-1]):
        spec[-1] = "model"
    return _constrain(x, P(*spec))


def expert_buffer(x):
    """(E, C, d): expert-parallel dispatch buffer — E on model."""
    if _state() is None:
        return x
    if _model_ok(x.shape[0]):
        return _constrain(x, P("model", None, None))
    return x


def expert_buffer_bucketed(x):
    """(S_dp, E, C_loc, d): source-shard-major dispatch buffer, dim 0 on
    the data axes, E on model."""
    if _state() is None:
        return x
    espec = "model" if _model_ok(x.shape[1]) else None
    return _constrain(x, P(_dp_for(x.shape[0]), espec, None, None))


def dp_size() -> int:
    st = _state()
    if st is None:
        return 1
    mesh, dp = st
    sizes = axis_sizes(mesh)
    size = 1
    for a in dp:
        size *= sizes[a]
    return size
