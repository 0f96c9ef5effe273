"""Disentanglement for local privatization (OCTOPUS §2.5, Eq. 4-6).

Port of ``repro.core.disentangle``. The latent splits into

  public  Z• = VQ(IN(Z_e(x)))          — codebook-carried content
  private Z∘ = E[Z_e(x) − Z•]          — per-group residual style

The instance norm strips per-instance channel statistics (the style
carriers) before quantization; the latent loss (Eq. 6, second term) pulls
IN(Z_e) toward its quantization: ``lambda * ||IN(Z_e(x)) − Z•||^2``.
``sg`` of the reference is ``detach`` here.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .gsvq import gsvq_quantize
from .vq import quantize


class DisentangledLatent(NamedTuple):
    public: torch.Tensor         # Z• quantized content, (..., M) (STE)
    private: torch.Tensor        # Z∘ group-averaged residual, broadcastable
    indices: torch.Tensor        # transmitted codes
    codebook_loss: torch.Tensor
    commit_loss: torch.Tensor
    latent_loss: torch.Tensor    # ||IN(z_e) - Z•||^2 (Eq. 6)


def instance_norm_latent(z_e: torch.Tensor, eps: float = 1e-5
                         ) -> torch.Tensor:
    """IN over the token/spatial axis of (B, T, M) latents (Eq. 4):
    channel-wise mean and population variance across positions."""
    mu = z_e.mean(dim=-2, keepdim=True)
    sigma = torch.sqrt(z_e.var(dim=-2, unbiased=False, keepdim=True) + eps)
    return (z_e - mu) / sigma


def split_public_private(z_e: torch.Tensor, codebook: torch.Tensor, *,
                         group_axis: Optional[int] = 0,
                         apply_in: bool = True, n_groups: int = 1,
                         n_slices: int = 1) -> DisentangledLatent:
    """Eq. 5: Z• = VQ(IN(z_e)), Z∘ = E_group[z_e − Z•].

    ``group_axis`` indexes attribute-sharing groups; ``None`` averages the
    residual per instance over positions (the axis before M).
    """
    z_in = instance_norm_latent(z_e) if apply_in else z_e
    if n_groups > 1 or n_slices > 1:
        q = gsvq_quantize(z_in, codebook, n_groups=n_groups,
                          n_slices=n_slices)
    else:
        q = quantize(z_in, codebook)
    residual = z_e - q.quantized.detach()
    axis = -2 if group_axis is None else group_axis
    private = residual.mean(dim=axis, keepdim=True)
    latent_loss = (z_in - q.quantized.detach()).square().mean()
    return DisentangledLatent(public=q.quantized, private=private,
                              indices=q.indices,
                              codebook_loss=q.codebook_loss,
                              commit_loss=q.commit_loss,
                              latent_loss=latent_loss)


def recombine(public: torch.Tensor, private: torch.Tensor) -> torch.Tensor:
    """Decoder input: Z• + Z∘ (Eq. 6 reconstruction path)."""
    return public + private


def perturb_private(generator: Optional[torch.Generator],
                    private: torch.Tensor, scale: float = 1.0
                    ) -> torch.Tensor:
    """§3.3 style transformation (1): Z∘' = Z∘ + scale * N(0, 1) noise
    drawn from ``generator`` on its own device -- an anonymized copy."""
    dev = None if generator is None else generator.device
    noise = torch.randn(private.shape, generator=generator,
                        dtype=private.dtype, device=dev)
    return private + scale * noise.to(private.device)


def replace_private(private_src: torch.Tensor) -> torch.Tensor:
    """§3.3 style transformation (2): swap in a reference sample's Z∘.
    Returned as is; named for the protocol's clarity."""
    return private_src


def total_loss(x: torch.Tensor, x_rec: torch.Tensor,
               dis: DisentangledLatent, *, alpha: float = 1.0,
               beta: float = 0.25, lam: float = 0.01):
    """Eq. 6 total: recon + alpha*codebook + beta*commit + lambda*latent.
    Returns (total, recon)."""
    recon = (x - x_rec).square().mean()
    return (recon + alpha * dis.codebook_loss + beta * dis.commit_loss
            + lam * dis.latent_loss), recon
