"""Codebook EMA updates (OCTOPUS §2.6, Eq. 7-9): the Step 5 refresh.

Port of the part of ``repro.core.ema`` the uplink needs: the refresh from
the sufficient statistics that the encode kernel emits, so the refresh
never re-runs the encoder. The fixed-point server merge comes with the
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
    return EMAState(
        counts=torch.ones((K,), dtype=torch.float32, device=codebook.device),
        sums=codebook.float().clone(), codebook=codebook)


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
