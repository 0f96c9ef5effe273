"""Vector quantization with the straight-through estimator (OCTOPUS Eq. 1).

Port of ``repro.core.vq``. Each M-dim latent maps to its nearest codebook
atom; only the int index is transmitted. Loss terms:

    L = ||x - D(z_q)||^2  +  alpha * ||sg[z_e] - e||^2  +  beta * ||z_e - sg[e]||^2

The nearest-atom search is the training step's hot spot: :func:`quantize`
runs it through ``repro_torch.kernels.ops.vq_nearest``, the CUDA kernel
for a tensor on the card and its plain version on the CPU. Ties go to the
lower atom index. ``sg`` is ``detach``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class VQOut(NamedTuple):
    quantized: torch.Tensor      # z_q, same shape as z_e (STE-passthrough)
    indices: torch.Tensor        # int32 codes, shape z_e.shape[:-1]
    codebook_loss: torch.Tensor  # ||sg[z_e] - e||^2
    commit_loss: torch.Tensor    # ||z_e - sg[e]||^2


def squared_distances(z: torch.Tensor, codebook: torch.Tensor
                      ) -> torch.Tensor:
    """Pairwise ||z - e||^2 by the expanded form: (N, M), (K, M) -> (N, K)."""
    z2 = (z * z).sum(-1, keepdim=True)
    e2 = (codebook * codebook).sum(-1)[None, :]
    return z2 - 2.0 * z @ codebook.T + e2


def nearest_atom(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest atoms by the full distance: (..., M) -> (...,) int32."""
    flat = z.reshape(-1, z.shape[-1])
    idx = squared_distances(flat, codebook).argmin(-1)
    return idx.reshape(z.shape[:-1]).to(torch.int32)


def kernel_nearest_atom(z: torch.Tensor, codebook: torch.Tensor
                        ) -> torch.Tensor:
    """:func:`nearest_atom` through ``ops.vq_nearest``. The inputs are
    detached: the argmin has no gradient, so the kernel needs no backward
    and sits inside a training step's autograd graph as a constant."""
    from repro_torch.kernels.ops import vq_nearest
    idx = vq_nearest(z.detach().reshape(-1, z.shape[-1]), codebook.detach())
    return idx.reshape(z.shape[:-1])


def quantize(z_e: torch.Tensor, codebook: torch.Tensor) -> VQOut:
    """Quantize (..., M) latents against a (K, M) codebook with the STE."""
    idx = kernel_nearest_atom(z_e, codebook)
    z_q = codebook[idx.long()]
    codebook_loss = (z_e.detach() - z_q).square().mean()
    commit_loss = (z_e - z_q.detach()).square().mean()
    # straight-through: forward z_q, backward identity to z_e
    z_st = z_e + (z_q - z_e).detach()
    return VQOut(quantized=z_st, indices=idx, codebook_loss=codebook_loss,
                 commit_loss=commit_loss)


def dequantize(indices: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Server-side lookup: int codes -> latent embeddings."""
    return codebook[indices.long()]


def vq_loss_terms(out: VQOut, alpha: float = 1.0, beta: float = 0.25):
    """alpha * codebook + beta * commitment (Eq. 1, second + third term)."""
    return alpha * out.codebook_loss + beta * out.commit_loss


def codes_nbits(indices: torch.Tensor, n_atoms: int) -> int:
    """Transmission cost of an index tensor in bits (§2.8)."""
    return int(indices.numel()) * max(1, math.ceil(math.log2(n_atoms)))


def perplexity(indices: torch.Tensor, n_atoms: int) -> torch.Tensor:
    """Codebook usage perplexity, exp(H(code distribution)); low values
    mean codebook collapse."""
    flat = indices.reshape(-1).long()
    counts = torch.bincount(flat, minlength=n_atoms).float()
    probs = counts / max(flat.numel(), 1)
    ent = -torch.where(probs > 0, probs * probs.clamp_min(1e-30).log(),
                       torch.zeros_like(probs)).sum()
    return ent.exp()
