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
``C = A`` (dropless) for a decode step (T = 1). The reference's
``_moe_shardmap`` and ``bucketed`` layouts need a device mesh; they come
with the distribution item of ROADMAP.md.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

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


def load_balance_loss(probs: torch.Tensor, idx: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-Transformer aux: E * sum_e f_e * P_e."""
    N, k = idx.shape
    counts = torch.bincount(idx.reshape(-1), minlength=n_experts).float()
    return n_experts * torch.sum(counts / (N * k) * probs.mean(0))


def positions_in_expert(expert_ids: torch.Tensor,
                        n_experts: int) -> torch.Tensor:
    """Rank of each assignment within its expert, by one stable argsort:
    (A,) expert ids -> (A,) int64 positions."""
    A = expert_ids.shape[0]
    order = torch.argsort(expert_ids, stable=True)
    counts = torch.bincount(expert_ids, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(A, device=expert_ids.device) \
        - starts[expert_ids[order]]
    return torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)


def moe_apply(params: dict, cfg, x: torch.Tensor, *,
              activation: str = "silu") -> MoEOut:
    """x (B, T, d) -> MoEOut(y (B, T, d), aux_loss scalar)."""
    m = cfg.moe
    B, T, d = x.shape
    N, k, E = B * T, m.n_experts_per_tok, m.n_experts
    xf = x.reshape(N, d)
    a = act_fn(activation)

    logits = xf.float() @ params["router"].float()
    gate, idx, probs = router_topk(logits, k, m.router_scoring)
    aux = m.router_aux_coef * load_balance_loss(probs, idx, E)
    aux = aux + 1e-3 * torch.mean(torch.logsumexp(logits, -1) ** 2)

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
    buf = buf.view(E, C, d)
    e = params["experts"]
    h = a(torch.bmm(buf, e["wi"])) * torch.bmm(buf, e["wg"])
    out_buf = torch.bmm(h, e["wo"]).view(E * C, d)
    del h
    # combine: gather back, gate, sum over the k slots of each token
    gathered = out_buf[slot] * (gates * keep).to(xf.dtype)[:, None]
    y = gathered.view(N, k, d).sum(1)

    if "shared" in params:
        s = params["shared"]
        y = y + (a(xf @ s["wi"]) * (xf @ s["wg"])) @ s["wo"]
    return MoEOut(y=y.view(B, T, d), aux_loss=aux)
