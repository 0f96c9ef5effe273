"""Codebook EMA updates (OCTOPUS §2.6, Eq. 7-9): the Step 5 refresh.

Port of ``repro.core.ema`` on one device: the refresh from the
sufficient statistics that the encode kernel emits, so the refresh never
re-runs the encoder, the refresh from explicit codes, and the Step 5
server merge's associative fixed-point statistics, and
:func:`ema_update_distributed`, the refresh from statistics summed over a
process group (the reference's ``shard_map`` body with a ``psum``).

    N_i <- gamma N_i + (1-gamma) n_i
    m_i <- gamma m_i + (1-gamma) sum_j z_{i,j}
    e_i <- m_i / N_i      (Laplace-smoothed)
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device


class EMAState(NamedTuple):
    counts: torch.Tensor      # N_i, (K,)
    sums: torch.Tensor        # m_i, (K, M)
    codebook: torch.Tensor    # e_i, (K, M)


def init_ema(codebook: torch.Tensor) -> EMAState:
    K, _ = codebook.shape
    codebook = codebook.detach()
    return EMAState(
        counts=torch.ones((K,), dtype=torch.float32, device=codebook.device),
        sums=codebook.float().clone(), codebook=codebook)


def assignment_stats(z_e: torch.Tensor, indices: torch.Tensor,
                     n_atoms: int):
    """Batch sufficient statistics (counts (K,), sums (K, M)) of (..., M)
    latents and their z_e.shape[:-1] int codes."""
    M = z_e.shape[-1]
    zf = z_e.reshape(-1, M).float()
    idx = indices.reshape(-1).long()
    n = torch.zeros((n_atoms,), dtype=torch.float32, device=zf.device)
    n.index_add_(0, idx, torch.ones_like(idx, dtype=torch.float32))
    s = torch.zeros((n_atoms, M), dtype=torch.float32, device=zf.device)
    s.index_add_(0, idx, zf)
    return n, s


def ema_update_from_stats(state: EMAState, n: torch.Tensor, s: torch.Tensor,
                          gamma: float = 0.99,
                          laplace_eps: float = 1e-5) -> EMAState:
    """One EMA step from per-atom counts ``n`` (..., K) and latent sums
    ``s`` (..., K, M); leading batch axes broadcast against ``state``."""
    K = n.shape[-1]
    counts = gamma * state.counts + (1.0 - gamma) * n
    sums = gamma * state.sums + (1.0 - gamma) * s
    # Laplace smoothing keeps dead atoms from collapsing to 0/0
    total = counts.sum(dim=-1, keepdim=True)
    smoothed = ((counts + laplace_eps) / (total + K * laplace_eps)) * total
    codebook = (sums / smoothed[..., None]).to(state.codebook.dtype)
    return EMAState(counts=counts, sums=sums, codebook=codebook)


def ema_update(state: EMAState, z_e: torch.Tensor, indices: torch.Tensor,
               gamma: float = 0.99, laplace_eps: float = 1e-5) -> EMAState:
    """One EMA step from (..., M) latents and their z_e.shape[:-1] codes."""
    n, s = assignment_stats(z_e, indices, state.codebook.shape[0])
    return ema_update_from_stats(state, n, s, gamma=gamma,
                                 laplace_eps=laplace_eps)


def ema_update_distributed(state: EMAState, z_e: torch.Tensor,
                           indices: torch.Tensor, gamma: float = 0.99, *,
                           group=None) -> EMAState:
    """One EMA step from the latents and codes of every rank of ``group``
    (a ``torch.distributed`` process group; the default group if None):
    each rank's ``assignment_stats``, then one ``all_reduce`` of the counts
    and one of the sums, and the same refresh on every rank. The paper's
    client-side weekly accumulation is the per-rank sums; the monthly
    server sync is the all-reduce."""
    import torch.distributed as dist
    n, s = assignment_stats(z_e, indices, state.codebook.shape[0])
    dist.all_reduce(n, group=group)
    dist.all_reduce(s, group=group)
    return ema_update_from_stats(state, n, s, gamma=gamma)


def batch_optimal_atoms(z_e: torch.Tensor, indices: torch.Tensor,
                        n_atoms: int):
    """Eq. 8: each atom's mean assigned latent (the EMA fixed point), and
    the counts -> ((K, M), (K,))."""
    n, s = assignment_stats(z_e, indices, n_atoms)
    return s / n.clamp(min=1.0)[:, None], n


# ---------------------------------------------------- associative Step-5 merge
#
# Averaging in floats is not associative, so a population merged cohort by
# cohort would drift in the last bits from the same population merged in
# one shot. MergeStats accumulates in fixed-point int64 instead: each
# client's contribution is quantized once, independently of its cohort,
# and summed with integer adds, which are exactly associative and
# commutative. The one division back to a codebook happens at the end.
#
# The totals equal the reference's (numpy float64) bit for bit on either
# device because every step is one correctly rounded IEEE operation:
# float64 casts and products in the reference's order, round half to even
# (``torch.round`` as ``np.rint``), int64 sums. Nothing here may be fused
# into a multiply-add. The one exception is the staleness decay: CUDA's
# double ``pow`` is not correctly rounded, so ``decay ** staleness`` is
# formed on the host with numpy, as the reference forms it.

MERGE_FIXED_BITS = 24                     # fractional bits of the fixed point
_MERGE_SCALE = float(1 << MERGE_FIXED_BITS)


class MergeStats(NamedTuple):
    """Associative sufficient statistics for the Step-5 codebook merge.

    num: (K, M) int64 -- sum over clients of round(count_k * cb_km * 2^24)
    den: (K,)  int64 -- sum over clients of round(count_k * 2^24)
    """
    num: torch.Tensor
    den: torch.Tensor


def merge_stats_zero(n_atoms: int, dim: int, *, device=None) -> MergeStats:
    """Identity element of :func:`merge_stats_add`, on ``device`` (cuda
    unless ``device="cpu"``)."""
    dev = resolve_device(device)
    return MergeStats(
        num=torch.zeros((n_atoms, dim), dtype=torch.int64, device=dev),
        den=torch.zeros((n_atoms,), dtype=torch.int64, device=dev))


def _device_of(x, device):
    """A tensor's device (a sequence's first element's); for numpy,
    :func:`~repro_torch.resolve_device` of ``device``."""
    first = x[0] if isinstance(x, (list, tuple)) and len(x) else x
    return first.device if torch.is_tensor(first) else resolve_device(device)


def as_stacked(x, device) -> torch.Tensor:
    """``x`` as one tensor on ``device``, without tracking gradients: a
    tensor, a numpy array, or a sequence of either (stacked)."""
    if isinstance(x, (list, tuple)):
        return torch.stack([torch.as_tensor(v).detach().to(device)
                            for v in x])
    return torch.as_tensor(x).detach().to(device)


def merge_stats(codebooks, counts, *, staleness=None,
                staleness_decay: float = 0.5, device=None) -> MergeStats:
    """Fixed-point merge statistics of a cohort: (C, K, M) codebooks and
    (C, K) counts, or one client's (K, M) and (K,), as tensors, numpy
    arrays or sequences of either. ``staleness``: optional (C,) rounds
    behind current, each client weighted ``staleness_decay ** staleness``.
    On the device of tensor ``codebooks``; numpy ones go to ``device``
    (cuda unless ``device="cpu"``)."""
    dev = _device_of(codebooks, device)
    cbs = as_stacked(codebooks, dev).to(torch.float64)
    w = as_stacked(counts, dev).to(torch.float64)
    if cbs.ndim == 2:
        cbs, w = cbs[None], w[None]
    if staleness is not None:
        st = np.asarray(torch.as_tensor(staleness).cpu(), np.float64)
        decay = np.power(float(staleness_decay), st)
        w = w * torch.from_numpy(decay).to(cbs.device)[:, None]
    den_f = w * _MERGE_SCALE                                 # (C, K)
    num_f = den_f[..., None] * cbs                           # (C, K, M)
    return MergeStats(num=torch.round(num_f).to(torch.int64).sum(dim=0),
                      den=torch.round(den_f).to(torch.int64).sum(dim=0))


def merge_stats_add(a: MergeStats, b: MergeStats, *,
                    device=None) -> MergeStats:
    """Exactly associative and commutative combine (int64 adds). Fields may
    be tensors or numpy int64 (the reference's); the sum lies on a tensor
    field's device, or on ``device`` (cuda unless ``device="cpu"``) when
    every field is numpy."""
    dev = next((f.device for f in (*a, *b) if torch.is_tensor(f)), None)
    if dev is None:
        dev = resolve_device(device)
    return MergeStats(num=as_stacked(a.num, dev) + as_stacked(b.num, dev),
                      den=as_stacked(a.den, dev) + as_stacked(b.den, dev))


def merge_codebook(stats: MergeStats, current, *,
                   device=None) -> torch.Tensor:
    """Finish the merge: integer totals (tensors or numpy int64) -> a
    codebook of ``current``'s dtype, on the device of tensor ``current``;
    a numpy one goes to ``device`` (cuda unless ``device="cpu"``). Atoms
    with no weight (``den <= 0``) keep their ``current`` row."""
    cur = as_stacked(current, _device_of(current, device))
    num = as_stacked(stats.num, cur.device)
    den = as_stacked(stats.den, cur.device)
    live = den > 0
    den = torch.where(live, den, 1).to(torch.float64)
    merged = num.to(torch.float64) / den[:, None]
    out = torch.where(live[:, None], merged, cur.to(torch.float64))
    return out.to(cur.dtype)
