"""Group and Sliced Vector Quantization (OCTOPUS §2.4): the decode side.

Port of the parts of ``repro.core.gsvq`` the serving slice needs: the
uniform group-mean table the server decodes GSVQ codes against, and the
uplink bits per position. The Eq. 2 group match itself runs inside the
encode kernel (``kernels/encode_codes``).
"""
from __future__ import annotations

import math

import torch


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
