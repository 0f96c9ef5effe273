"""Mixture-of-Experts: top-k router and sort-based capacity dispatch.

Port of ``repro.nn.moe``'s flat dispatch, the path the reference takes off
a mesh:

  1. top-k routing -> an (assignment = token x k) list of experts,
  2. each assignment's rank within its expert by one stable argsort,
  3. a scatter of the kept tokens into an (E*C, d) buffer (an assignment
     ranked past the capacity C is dropped),
  4. batched expert products over the leading expert axis (plain products,
     as the reference leaves them to XLA),
  5. a gather back, scaled by the gates and summed over the k slots.

Capacity is ``C = max(k, round(A * capacity_factor / E))`` for T > 1 and
``C = A`` (dropless) for a decode step (T = 1).

On a device mesh (DTensor activations under ``hints.activation_sharding``)
the reference's conditions pick the layout (``repro.nn.moe.moe_apply``):

* ``dispatch="shardmap"``, T > 1, a model axis of tp > 1 dividing E and a
  batch the data axes divide: :func:`_moe_shardmap`. Each model rank
  routes its data shard's tokens, keeps the assignments to its own E/tp
  experts, computes capacity and slot positions per data shard (so drops
  differ from the flat dispatch's), runs its experts, and y is summed over
  the model group; the aux loss is averaged over the data group.
* ``dispatch="bucketed"``, more than one data shard dividing the tokens:
  the (S, E, C_loc, d) buffer, capacity and positions per (source shard,
  expert) (:func:`_bucketed`).
* otherwise the flat dispatch above (a decode step always), on every
  rank's whole copy of the layer's tokens and weights.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import hints
from repro_torch.nn.layers import act_fn, dense_init, uniform_init


class MoEOut(NamedTuple):
    y: torch.Tensor
    aux_loss: torch.Tensor


def init_moe(cfg, *, generator: Optional[torch.Generator] = None) -> dict:
    """Router (d, E) and expert stacks (E, d_in, d_out), each U(±1/sqrt
    (d_in)) as the reference draws them, on the generator's device; shared
    experts where the config has them."""
    m = cfg.moe
    d = cfg.d_model

    def expert_stack(d_in, d_out):
        return uniform_init((m.n_experts, d_in, d_out), d_in ** -0.5,
                            generator=generator)

    p = {"router": dense_init(d, m.n_experts, generator=generator),
         "experts": {"wi": expert_stack(d, m.d_ff_expert),
                     "wg": expert_stack(d, m.d_ff_expert),
                     "wo": expert_stack(m.d_ff_expert, d)}}
    if m.n_shared_experts:
        ff_sh = m.n_shared_experts * m.d_ff_expert
        p["shared"] = {"wi": dense_init(d, ff_sh, generator=generator),
                       "wg": dense_init(d, ff_sh, generator=generator),
                       "wo": dense_init(ff_sh, d, generator=generator)}
    return p


def router_topk(logits: torch.Tensor, k: int, scoring: str = "softmax"):
    """logits (N, E) float32 -> (gate (N, k), idx (N, k), probs (N, E))."""
    if scoring == "sigmoid":
        scores = torch.sigmoid(logits)
        gate, idx = torch.topk(scores, k, dim=-1)
        probs = scores / scores.sum(-1, keepdim=True).clamp(min=1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        gate, idx = torch.topk(probs, k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    return gate, idx, probs


def expert_counts(expert_ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """(A,) expert ids -> (n_experts,) int64 assignments an expert: a
    bincount whose length does not depend on the ids' values, so that it
    also runs on fake tensors (integer sums, the same in any order)."""
    return torch.zeros(n_experts, dtype=torch.int64,
                       device=expert_ids.device).scatter_add_(
        0, expert_ids.long(), torch.ones_like(expert_ids, dtype=torch.int64))


def load_balance_loss(probs: torch.Tensor, idx: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-Transformer aux: E * sum_e f_e * P_e."""
    N, k = idx.shape
    counts = expert_counts(idx.reshape(-1), n_experts).float()
    return n_experts * torch.sum(counts / (N * k) * probs.mean(0))


def positions_in_expert(expert_ids: torch.Tensor,
                        n_experts: int) -> torch.Tensor:
    """Rank of each assignment within its expert, by one stable argsort:
    (A,) expert ids -> (A,) int64 positions."""
    A = expert_ids.shape[0]
    order = torch.argsort(expert_ids, stable=True)
    counts = expert_counts(expert_ids, n_experts)
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(A, device=expert_ids.device) \
        - starts[expert_ids[order]]
    return torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)


def _route(m, router, xf):
    """Router logits of the (N, d) tokens -> (gate (N, k), idx (N, k), the
    load-balance and z-loss aux)."""
    logits = xf.float() @ router.float()
    gate, idx, probs = router_topk(logits, m.n_experts_per_tok,
                                   m.router_scoring)
    aux = m.router_aux_coef * load_balance_loss(probs, idx, m.n_experts)
    aux = aux + 1e-3 * torch.mean(torch.logsumexp(logits, -1) ** 2)
    return gate, idx, aux


def _experts(e, buf, a):
    """The batched expert products of an (E, C, d) buffer."""
    h = a(torch.bmm(buf, e["wi"])) * torch.bmm(buf, e["wg"])
    return torch.bmm(h, e["wo"])


def _shared(params, xf, a):
    s = params["shared"]
    return (a(xf @ s["wi"]) * (xf @ s["wg"])) @ s["wo"]


def moe_apply(params: dict, cfg, x: torch.Tensor, *,
              activation: str = "silu") -> MoEOut:
    """x (B, T, d) -> MoEOut(y (B, T, d), aux_loss scalar). A DTensor
    under ``hints.activation_sharding`` takes the mesh layouts (module
    docstring)."""
    st = hints._state()
    if st is not None and hints.is_dtensor(x):
        return _moe_mesh(params, cfg, x, activation, *st)
    return _moe_flat(params, cfg, x, activation)


def _moe_flat(params: dict, cfg, x: torch.Tensor,
              activation: str) -> MoEOut:
    m = cfg.moe
    B, T, d = x.shape
    N, k, E = B * T, m.n_experts_per_tok, m.n_experts
    xf = x.reshape(N, d)
    a = act_fn(activation)
    gate, idx, aux = _route(m, params["router"], xf)

    A = N * k
    expert_ids = idx.reshape(A)
    gates = gate.reshape(A)
    token_ids = torch.arange(N, device=x.device).repeat_interleave(k)
    # decode (T == 1) runs dropless, so a single token's output matches the
    # teacher-forced path's; the floor at k keeps tiny batches' first
    # choices
    C = A if T == 1 else max(k, int(round(A * m.capacity_factor / E)))
    pos = positions_in_expert(expert_ids, E)
    keep = pos < C
    slot = torch.where(keep, expert_ids * C + pos, torch.zeros_like(pos))
    # dispatch: the kept tokens into (E*C, d); a dropped one adds zeros to
    # slot 0, as the reference's scatter-add does
    updates = xf[token_ids] * keep[:, None].to(xf.dtype)
    buf = xf.new_zeros((E * C, d)).index_add_(0, slot, updates)
    out_buf = _experts(params["experts"], buf.view(E, C, d), a) \
        .view(E * C, d)
    # combine: gather back, gate, sum over the k slots of each token
    gathered = out_buf[slot] * (gates * keep).to(xf.dtype)[:, None]
    y = gathered.view(N, k, d).sum(1)

    if "shared" in params:
        y = y + _shared(params, xf, a)
    return MoEOut(y=y.view(B, T, d), aux_loss=aux)


# ------------------------------------------------------------------ mesh

def _axis_placements(mesh, dp_axes, *, on_dp, on_model, other=None):
    """One placement a mesh dim: ``on_dp`` on the data axes, ``on_model``
    on 'model', ``other`` (Replicate) elsewhere."""
    from torch.distributed.tensor import Replicate
    return tuple(on_dp if n in dp_axes else on_model if n == "model"
                 else (other or Replicate()) for n in mesh.mesh_dim_names)


def _moe_mesh(params, cfg, x, activation, mesh, dp_axes) -> MoEOut:
    from repro_torch.distributed.sharding import axis_sizes
    m = cfg.moe
    B, T, _ = x.shape
    tp = axis_sizes(mesh).get("model", 1)
    if m.dispatch == "shardmap" and T > 1 and tp > 1 \
            and m.n_experts % tp == 0 and B % hints.dp_size() == 0:
        return _moe_shardmap(params, cfg, x, mesh, dp_axes, activation)
    S = hints.dp_size()
    from repro_torch.kernels._mesh import replicate_local

    def whole(xx, p):
        if m.dispatch == "bucketed" and S > 1 and (B * T) % S == 0:
            return _bucketed(p, cfg, xx, S, activation)
        return _moe_flat(p, cfg, xx, activation)

    return replicate_local(whole, [x, params], mesh)


def _bucketed(params, cfg, x, S: int, activation: str) -> MoEOut:
    """The reference's ``bucketed`` layout on whole tensors: tokens in S
    contiguous source shards, an (S, E, C_loc, d) buffer with each
    assignment ranked within its (shard, expert) segment and capacity
    ``C_loc = max(1, round(A * capacity_factor / (E * S)))``."""
    m = cfg.moe
    B, T, d = x.shape
    N, k, E = B * T, m.n_experts_per_tok, m.n_experts
    xf = x.reshape(N, d)
    a = act_fn(activation)
    gate, idx, aux = _route(m, params["router"], xf)
    A = N * k
    expert_ids, gates = idx.reshape(A), gate.reshape(A)
    token_ids = torch.arange(N, device=x.device).repeat_interleave(k)
    C = max(1, int(round(A * m.capacity_factor / (E * S))))
    seg = (token_ids // (N // S)) * E + expert_ids
    pos = positions_in_expert(seg, S * E)
    keep = pos < C
    slot = torch.where(keep, seg * C + pos, torch.zeros_like(pos))
    updates = xf[token_ids] * keep[:, None].to(xf.dtype)
    buf = xf.new_zeros((S * E * C, d)).index_add_(0, slot, updates)
    # expert-major: (S, E, C, d) -> (E, S * C, d)
    bufe = buf.view(S, E, C, d).transpose(0, 1).reshape(E, S * C, d)
    out_e = _experts(params["experts"], bufe, a)
    out_buf = out_e.view(E, S, C, d).transpose(0, 1).reshape(S * E * C, d)
    gathered = out_buf[slot] * (gates * keep).to(xf.dtype)[:, None]
    y = gathered.view(N, k, d).sum(1)
    if "shared" in params:
        y = y + _shared(params, xf, a)
    return MoEOut(y=y.view(B, T, d), aux_loss=aux)


def _moe_shardmap(params, cfg, x, mesh, dp_axes, activation) -> MoEOut:
    """Expert parallelism (the reference's ``_moe_shardmap``): the tokens
    stay on their data shard, replicated over 'model'; model rank j routes
    them, keeps the assignments to its experts [j E/tp, (j + 1) E/tp),
    ranks them by expert per data shard (capacity from the shard's A),
    runs its experts and gives a partial y, summed over the model group.
    Two ``local_map`` calls: the routing (gradient to the router summed
    over the data group; the aux loss averaged over it) and the experts (x
    and the gates' gradients summed over the model group, the experts'
    over the data group)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.distributed.sharding import axis_sizes
    from repro_torch.kernels._mesh import relayout
    m = cfg.moe
    B, T, d = x.shape
    k, E = m.n_experts_per_tok, m.n_experts
    names = tuple(mesh.mesh_dim_names)
    tp = axis_sizes(mesh)["model"]
    e_loc = E // tp
    j_model = names.index("model")
    dsz = hints.dp_size()
    a = act_fn(activation)
    R = Replicate()
    rep = (R,) * len(names)
    xp = _axis_placements(mesh, dp_axes, on_dp=Shard(0), on_model=R)
    wp = _axis_placements(mesh, dp_axes, on_dp=R, on_model=Shard(0))
    wgrad = _axis_placements(mesh, dp_axes, on_dp=Partial(),
                             on_model=Shard(0))
    part_model = _axis_placements(mesh, dp_axes, on_dp=Shard(0),
                                  on_model=Partial())
    auxp = _axis_placements(mesh, dp_axes, on_dp=Partial(), on_model=R)
    router_grad = auxp

    x = relayout(x, mesh, xp)
    router = params["router"]
    router = relayout(router, mesh, rep) if hints.is_dtensor(router) \
        else router
    e = params["experts"]
    ws = [relayout(w, mesh, wp) for w in (e["wi"], e["wg"], e["wo"])]

    def route(xb, r):
        gate, idx, aux = _route(m, r, xb.reshape(-1, d))
        return gate, idx, aux / dsz              # the mean over the data
    gate, idx, aux = local_map(
        route, out_placements=(xp, xp, auxp), in_placements=(xp, rep),
        in_grad_placements=(xp, router_grad), device_mesh=mesh)(x, router)

    def experts(xb, g, ix, wi, wg, wo):
        n = xb.shape[0] * xb.shape[1]
        xf = xb.reshape(n, d)
        A = n * k
        expert_ids, gates = ix.reshape(A), g.reshape(A)
        token_ids = torch.arange(n, device=xb.device).repeat_interleave(k)
        local_e = expert_ids - mesh.get_local_rank(j_model) * e_loc
        mine = (local_e >= 0) & (local_e < e_loc)
        C = max(k, int(round(A * m.capacity_factor / E)))
        seg = torch.where(mine, local_e, torch.full_like(local_e, e_loc))
        pos = positions_in_expert(seg, e_loc + 1)   # e_loc: the discards
        keep = mine & (pos < C)
        slot = torch.where(keep, seg * C + pos,
                           torch.full_like(pos, e_loc * C))
        updates = xf[token_ids] * keep[:, None].to(xf.dtype)
        buf = xf.new_zeros((e_loc * C + 1, d)).index_add_(0, slot, updates)
        out_buf = _experts({"wi": wi, "wg": wg, "wo": wo},
                           buf[:e_loc * C].view(e_loc, C, d), a)
        out_buf = torch.cat([out_buf.reshape(e_loc * C, d),
                             out_buf.new_zeros((1, d))])
        gathered = out_buf[slot] * (gates * keep).to(xf.dtype)[:, None]
        return gathered.view(n, k, d).sum(1).view(xb.shape)

    y = local_map(
        experts, out_placements=(part_model,),
        in_placements=(xp, xp, xp, wp, wp, wp),
        in_grad_placements=(part_model, part_model, xp, wgrad, wgrad,
                            wgrad),
        device_mesh=mesh)(x, gate, idx, *ws)
    y = relayout(y, mesh, xp)                    # the sum over 'model'
    aux = relayout(aux, mesh, rep)
    if "shared" in params:
        s = params["shared"]
        xf = x.reshape(B * T, d)
        hdn = hints.ffn_hidden((a(xf @ s["wi"]) * (xf @ s["wg"]))
                               .reshape(B, T, -1)).reshape(B * T, -1)
        y = y + (hdn @ s["wo"]).reshape(B, T, d)
    return MoEOut(y=y, aux_loss=aux)
