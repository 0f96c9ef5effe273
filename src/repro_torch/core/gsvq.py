"""Group and Sliced Vector Quantization (OCTOPUS §2.4, Eq. 2-3).

Port of ``repro.core.gsvq``. GVQ partitions the (K, M) codebook into G
groups of K/G atoms; a latent goes to the group with the least mean atom
distance (Eq. 2) and is quantized to the inverse-distance-weighted
average of that group's atoms (Eq. 3). SVQ slices atoms and latents into
n_c parts along M and quantizes each slice on its own. The reference
``vmap``s over slices; here the slice is a leading batch axis. The group
match of the uplink runs inside the encode kernel
(``kernels/encode_codes``); training runs it here in plain PyTorch, as
the reference does in jnp.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class GSVQOut(NamedTuple):
    quantized: torch.Tensor      # STE-passthrough quantized latents (..., M)
    indices: torch.Tensor        # (..., n_c) int32 group indices per slice
    codebook_loss: torch.Tensor
    commit_loss: torch.Tensor


def _group_distances(z: torch.Tensor, codebook: torch.Tensor,
                     n_groups: int) -> torch.Tensor:
    """Mean per-group L2 distance (Eq. 2): z (..., N, m), codebook
    (..., K, m) -> (..., N, G)."""
    K = codebook.shape[-2]
    z2 = (z * z).sum(-1, keepdim=True)
    e2 = (codebook * codebook).sum(-1).unsqueeze(-2)
    d2 = torch.clamp(z2 - 2.0 * (z @ codebook.transpose(-1, -2)) + e2,
                     min=0.0)
    d = torch.sqrt(d2 + 1e-12)
    return d.reshape(d.shape[:-1] + (n_groups, K // n_groups)).mean(-1)


def _group_weighted_average(z: torch.Tensor, group_atoms: torch.Tensor
                            ) -> torch.Tensor:
    """Inverse-distance-weighted atom average (Eq. 3): z (..., N, m),
    group_atoms (..., N, N_g, m) -> (..., N, m)."""
    d = torch.sqrt((z.unsqueeze(-2) - group_atoms).square().sum(-1) + 1e-12)
    w = 1.0 / (d + 1e-8)
    w = w / w.sum(-1, keepdim=True)
    return torch.einsum("...ng,...ngm->...nm", w, group_atoms)


def _slices(z_e: torch.Tensor, codebook: torch.Tensor, n_slices: int):
    """(..., M) latents, (K, M) codebook -> (n_c, N, m), (n_c, K, m)."""
    K, M = codebook.shape
    m = M // n_slices
    zs = z_e.reshape(-1, n_slices, m).transpose(0, 1)
    cs = codebook.reshape(K, n_slices, m).transpose(0, 1)
    return zs, cs


def gsvq_quantize(z_e: torch.Tensor, codebook: torch.Tensor, *,
                  n_groups: int = 1, n_slices: int = 1) -> GSVQOut:
    """Group + sliced quantization with the STE. z_e (..., M), codebook
    (K, M); M must divide by n_slices and K by n_groups."""
    K, M = codebook.shape
    if M % n_slices or K % n_groups:
        raise ValueError(f"M={M} must divide by n_slices={n_slices} and "
                         f"K={K} by n_groups={n_groups}")
    m, ng = M // n_slices, K // n_groups
    zs, cs = _slices(z_e, codebook, n_slices)
    gidx = _group_distances(zs, cs, n_groups).argmin(-1)        # (n_c, N)
    groups = cs.reshape(n_slices, n_groups, ng, m)
    atoms = groups[torch.arange(n_slices, device=gidx.device)[:, None],
                   gidx]                                         # (n_c, N, ng, m)
    zq = _group_weighted_average(zs, atoms)                      # (n_c, N, m)
    zq = zq.transpose(0, 1).reshape(z_e.shape)
    gidx = gidx.transpose(0, 1).reshape(z_e.shape[:-1] + (n_slices,))
    codebook_loss = (z_e.detach() - zq).square().mean()
    commit_loss = (z_e - zq.detach()).square().mean()
    z_st = z_e + (zq - z_e).detach()
    return GSVQOut(quantized=z_st, indices=gidx.to(torch.int32),
                   codebook_loss=codebook_loss, commit_loss=commit_loss)


def gsvq_indices(z_e: torch.Tensor, codebook: torch.Tensor, *,
                 n_groups: int = 1, n_slices: int = 1) -> torch.Tensor:
    """Index-only GSVQ match: (..., M) -> (..., n_c) int32 group indices,
    the same Eq. 2 argmin as :func:`gsvq_quantize` without Eq. 3."""
    zs, cs = _slices(z_e, codebook, n_slices)
    gidx = _group_distances(zs, cs, n_groups).argmin(-1)
    return gidx.transpose(0, 1).reshape(z_e.shape[:-1] + (n_slices,)) \
        .to(torch.int32)


def gsvq_group_mean_table(codebook: torch.Tensor, *, n_groups: int,
                          n_slices: int) -> torch.Tensor:
    """(K, M) codebook -> (n_slices, n_groups, m) uniform group means: row
    ``(s, g)`` is the mean of group ``g``'s atoms restricted to slice
    ``s``."""
    K, M = codebook.shape
    m = M // n_slices
    ng = K // n_groups
    cb = codebook.reshape(K, n_slices, m).permute(1, 0, 2)     # (n_c, K, m)
    return cb.reshape(n_slices, n_groups, ng, m).mean(dim=2)


def gsvq_bits_per_position(n_groups: int, n_slices: int) -> int:
    """Uplink bits per latent position (§2.8): ``n_slices`` group indices
    of ``ceil(log2 n_groups)`` bits each (1-bit floor)."""
    return n_slices * max(1, math.ceil(math.log2(max(n_groups, 2))))
