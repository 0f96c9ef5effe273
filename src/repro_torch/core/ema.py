"""Codebook EMA updates (OCTOPUS §2.6, Eq. 7-9): the Step 5 refresh.

Port of the part of ``repro.core.ema`` the client needs: the refresh from
the sufficient statistics that the encode kernel emits, so the refresh
never re-runs the encoder, and :func:`assignment_stats` for a refresh
from explicit codes. The fixed-point server merge comes with the
population slice.

    N_i <- gamma N_i + (1-gamma) n_i
    m_i <- gamma m_i + (1-gamma) sum_j z_{i,j}
    e_i <- m_i / N_i      (Laplace-smoothed)
"""
from __future__ import annotations

from typing import NamedTuple

import torch


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
