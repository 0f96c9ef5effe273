"""VQ nearest-atom search: the CUDA wrapper.

Port of ``repro.kernels.vq_nn``. For N latent rows (N, M) and K atoms
(K, M), the index of the nearest atom under ``||e||^2 - 2 z.e`` (the
row-constant ``||z||^2`` dropped), ties to the lower index. The kernel is
``csrc/vq_nn.cu``; its plain version is
:func:`repro_torch.kernels.ref.vq_nearest_ref`.
"""
from __future__ import annotations

import torch

from . import _build
from .pack_bits import _require_cuda

#: widest atom the kernel takes (the reference's "64-256")
MAX_DIM = 256


def vq_nearest_cuda(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """(N, M) float32 latents + (K, M) float32 codebook on the card ->
    (N,) int32 nearest-atom indices."""
    _require_cuda(z, "z", torch.float32)
    _require_cuda(codebook, "codebook", torch.float32)
    if z.dim() != 2 or codebook.dim() != 2 or z.shape[1] != codebook.shape[1]:
        raise ValueError(f"z must be (N, M) and codebook (K, M), got "
                         f"{tuple(z.shape)} and {tuple(codebook.shape)}")
    N, M = z.shape
    K = codebook.shape[0]
    if not 1 <= M <= MAX_DIM:
        raise ValueError(f"the kernel takes atoms of 1 to {MAX_DIM} values, "
                         f"got {M}")
    if K < 1:
        raise ValueError("the codebook has no atoms")
    out = torch.empty((N,), dtype=torch.int32, device=z.device)
    if N:
        _build.check(_build.library().rt_vq_nearest(
            z.data_ptr(), codebook.data_ptr(), out.data_ptr(), N, K, M,
            z.get_device(), _build.stream_of(z)), "vq_nearest")
    return out
