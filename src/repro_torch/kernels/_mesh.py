"""The LM kernels on a device mesh: ``local_map`` over DTensors.

A hand-written kernel takes plain tensors. On the mesh path
(:mod:`repro_torch.distributed`) the LM's tensors are DTensors, so
:mod:`.ops` hands them here: each input is redistributed, where it must
be, to placements under which every rank's shard is a problem of its own,
and ``local_map`` calls the entry point in :mod:`.ops` on each rank's local
tensors (the kernel on the card, its plain version on the CPU, as for any
tensor). Per mesh dim:

* ``rmsnorm``: rows sharded anywhere, the normalised (last) dim whole.
  The scale's gradient sums over the ranks that hold other rows.
* ``flash_attention`` (and its backward, inside the autograd Function the
  local call builds): batch on a dim, or query heads. KV heads shard with
  the query heads where both divide; otherwise they stay whole and each
  rank takes the KV heads its query heads read (the contiguous groups, or
  one a query head), their gradients summed over the ranks. Any other
  layout (a query sequence sharded by ``hints.heads``' fallback, a head
  dim sharded at decode) is gathered to whole rows first: the kernel's
  causal mask counts query positions from a shard's start.
* ``selective_scan``: batch or channels sharded, time and state whole; C
  is whole where channels are sharded, and its gradient sums over them.

Nothing here falls back to a plain version on the card: a layout that no
rule takes is redistributed, never computed another way.
"""
from __future__ import annotations

import torch


def _dt():
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    return DTensor, Partial, Replicate, Shard


def _as_dtensor(t, mesh):
    """``t`` as a DTensor of ``mesh``: a plain tensor is taken as
    replicated."""
    DTensor, _, Replicate, _ = _dt()
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def relayout(t, mesh, placements):
    """``t`` redistributed to ``placements``, or ``t`` itself if it has
    them already (a no-op redistribution still costs DTensor's
    bookkeeping on every call)."""
    if tuple(t.placements) == tuple(placements):
        return t
    return t.redistribute(mesh, placements)


def _even(shape, placements, mesh) -> tuple:
    """``placements`` with each Shard whose dim the mesh dims sharding it
    do not divide evenly made Replicate (``local_map`` rebuilds outputs
    from even shards)."""
    _, _, Replicate, _ = _dt()
    out = list(placements)
    for d in range(len(shape)):
        dims = [i for i, p in enumerate(out) if p.is_shard(d)]
        size = 1
        for i in dims:
            size *= mesh.size(i)
        if dims and shape[d] % size:
            for i in dims:
                out[i] = Replicate()
    return tuple(out)


def _local_map(fn, out, ins, grads, mesh):
    from torch.distributed.tensor.experimental import local_map
    return local_map(fn, out_placements=out, in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh)


def rmsnorm_mesh(rmsnorm, x, scale, eps: float):
    """``rmsnorm(x, scale, eps=eps)`` on each rank's rows."""
    _, Partial, Replicate, _ = _dt()
    mesh = x.device_mesh
    last = x.ndim - 1
    xp = _even(x.shape, tuple(
        p if p.is_shard() and p.dim != last else Replicate()
        for p in x.placements), mesh)
    x = relayout(x, mesh, xp)
    rep = (Replicate(),) * mesh.ndim
    scale = relayout(_as_dtensor(scale, mesh), mesh, rep)
    # each rank's rows give a part of the scale's gradient
    gscale = tuple(Partial() if p.is_shard() else Replicate() for p in xp)
    return _local_map(lambda a, s: rmsnorm(a, s, eps=eps), (xp,), (xp, rep),
                      (xp, gscale), mesh)(x, scale)


def heads_local(fn, q, k, v, mask=None):
    """``fn(q, k, v, mask)``, attention over local tensors, on each rank's
    (batch, query head) shard: q (B, Tq, Hq, D), k and v (B, Tk, Hkv, D),
    ``mask`` None or a (B, Tk) tensor -> a (B, Tq, Hq, Dv) DTensor laid
    out as q. Per mesh dim q keeps its batch or head sharding (anything
    else is gathered); k, v and the mask follow its batch; KV heads shard
    with the query heads where both divide evenly, else stay whole and
    each rank takes the KV heads its query heads read (their gradients
    summed over the ranks)."""
    _, Partial, Replicate, Shard = _dt()
    mesh = q.device_mesh
    k, v = _as_dtensor(k, mesh), _as_dtensor(v, mesh)
    Hq, Hkv = q.shape[2], k.shape[2]
    qp = tuple(p if p.is_shard(0) or p.is_shard(2) else Replicate()
               for p in q.placements)
    qp = _even(q.shape, qp, mesh)
    heads = [i for i, p in enumerate(qp) if p.is_shard(2)]
    if len(heads) > 1:                   # heads over two mesh dims
        qp = tuple(Replicate() if p.is_shard(2) else p for p in qp)
        heads = []
    kvp, kv_grad, select = [], [], None
    for i, p in enumerate(qp):
        if p.is_shard(0):
            kvp.append(Shard(0))
            kv_grad.append(Shard(0))
        elif i in heads and Hkv % mesh.size(i) == 0:
            kvp.append(Shard(2))         # rep = Hq / Hkv kept on each rank
            kv_grad.append(Shard(2))
        elif i in heads:                 # KV heads whole: take this rank's
            kvp.append(Replicate())
            kv_grad.append(Partial())
            select = i
        else:
            kvp.append(Replicate())
            kv_grad.append(Replicate())
    kvp, kv_grad = tuple(kvp), tuple(kv_grad)
    q = relayout(q, mesh, qp)
    k, v = relayout(k, mesh, kvp), relayout(v, mesh, kvp)
    args, ins, grads = [q, k, v], [qp, kvp, kvp], [qp, kv_grad, kv_grad]
    if mask is not None:
        mp = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in qp)
        args.append(relayout(_as_dtensor(mask, mesh), mesh, mp))
        ins.append(mp)
        grads.append(mp)

    def local(a, b, c, m=None):
        if select is not None:
            L, rep = a.shape[2], Hq // Hkv
            first = mesh.get_local_rank(select) * L
            if L % rep == 0:             # whole groups: their KV heads
                b = b.narrow(2, first // rep, L // rep)
                c = c.narrow(2, first // rep, L // rep)
            else:                        # one KV head a query head
                idx = torch.arange(first, first + L, device=b.device) // rep
                b, c = b.index_select(2, idx), c.index_select(2, idx)
        return fn(a, b, c, m)

    return _local_map(local, (qp,), tuple(ins), tuple(grads), mesh)(*args)


def flash_attention_mesh(flash_attention, q, k, v, *, causal: bool,
                         window: int):
    """``flash_attention(q, k, v, ...)`` on each rank's (batch, query
    head) shard (:func:`heads_local`)."""
    return heads_local(lambda a, b, c, m: flash_attention(
        a, b, c, causal=causal, window=window), q, k, v)


def selective_scan_mesh(selective_scan, decay, inp, c, h0):
    """``selective_scan(decay, inp, c, h0)`` on each rank's (batch,
    channel) shard -> (y, h_last) DTensors."""
    _, Partial, Replicate, Shard = _dt()
    mesh = decay.device_mesh
    inp, c, h0 = (_as_dtensor(t, mesh) for t in (inp, c, h0))
    dp = tuple(p if p.is_shard(0) or p.is_shard(2) else Replicate()
               for p in decay.placements)
    dp = _even(decay.shape, dp, mesh)
    cp = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in dp)
    c_grad = tuple(Shard(0) if p.is_shard(0) else
                   Partial() if p.is_shard(2) else Replicate() for p in dp)
    hp = tuple(Shard(0) if p.is_shard(0) else
               Shard(1) if p.is_shard(2) else Replicate() for p in dp)
    decay, inp = relayout(decay, mesh, dp), relayout(inp, mesh, dp)
    c, h0 = relayout(c, mesh, cp), relayout(h0, mesh, hp)
    yp = dp                              # (B, T, di): as decay's first 3
    return _local_map(lambda a, b, cc, h: selective_scan(a, b, cc, h),
                      (yp, hp), (dp, dp, cp, hp), (dp, dp, c_grad, hp),
                      mesh)(decay, inp, c, h0)


def depthwise_mesh(conv, x, kernel):
    """``conv(x, kernel)``, a causal depthwise conv of x (B, T, C) with a
    (K, C) kernel, on each rank's (batch, channel) shard; time whole."""
    _, Partial, Replicate, Shard = _dt()
    mesh = x.device_mesh
    xp = _even(x.shape, tuple(p if p.is_shard(0) or p.is_shard(2)
                              else Replicate() for p in x.placements), mesh)
    kp = tuple(Shard(1) if p.is_shard(2) else Replicate() for p in xp)
    kgrad = tuple(Shard(1) if p.is_shard(2) else
                  Partial() if p.is_shard(0) else Replicate() for p in xp)
    x = relayout(x, mesh, xp)
    kernel = relayout(_as_dtensor(kernel, mesh), mesh, kp)
    return _local_map(conv, (xp,), (xp, kp), (xp, kgrad), mesh)(x, kernel)


def replicate_local(fn, args, mesh):
    """``fn(*args)`` on every rank's whole copy of ``args`` (a pytree:
    DTensor leaves gathered to replicated, plain ones as they are) -> its
    output with every tensor a replicated DTensor: the same function,
    computed on every rank."""
    from torch.utils import _pytree as pytree
    DTensor, _, Replicate, _ = _dt()
    rep = (Replicate(),) * mesh.ndim
    local = pytree.tree_map(
        lambda a: relayout(a, mesh, rep).to_local()
        if isinstance(a, DTensor) else a, list(args))
    return pytree.tree_map(
        lambda t: DTensor.from_local(t, mesh, rep, run_check=False)
        if isinstance(t, torch.Tensor) else t, fn(*local))
