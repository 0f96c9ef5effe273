"""Disentanglement for local privatization (OCTOPUS §2.5, Eq. 4).

Port of the part of ``repro.core.disentangle`` that the uplink runs: the
instance norm that strips per-instance channel statistics (the style
carriers) from the latents before they are quantized. The public/private
split and its losses come with the training slice.
"""
from __future__ import annotations

import torch


def instance_norm_latent(z_e: torch.Tensor, eps: float = 1e-5
                         ) -> torch.Tensor:
    """IN over the token/spatial axis of (B, T, M) latents (Eq. 4):
    channel-wise mean and population variance across positions."""
    mu = z_e.mean(dim=-2, keepdim=True)
    sigma = torch.sqrt(z_e.var(dim=-2, unbiased=False, keepdim=True) + eps)
    return (z_e - mu) / sigma
