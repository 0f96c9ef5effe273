"""Fused packed-code -> feature decode: slice phases and CUDA wrapper.

Port of ``repro.kernels.decode_codes``. Packed words go straight to rows
of a decode table: for plain VQ the codebook ``(K, M)``; for GSVQ the
per-slice group-mean table ``(n_slices * n_groups, m)``, where code ``j``
of stream group ``g`` gathers row ``((phase[g] + j) % n_slices) * rows +
code``. The kernel is ``csrc/decode_codes.cu``; its plain version is
:func:`repro_torch.kernels.ref.decode_codes_ref`.
"""
from __future__ import annotations

import torch

from . import _build
from .pack_bits import _require_cuda, packing_dims


def stream_phases(n_stream_groups: int, bits: int, n_slices: int, *,
                  device=None) -> torch.Tensor:
    """Slice id of each super-group's first code for a contiguous record:
    group ``g`` starts at code ``g * G``, so its phase is
    ``(g * G) % n_slices``."""
    G, _ = packing_dims(bits)
    return (torch.arange(n_stream_groups, dtype=torch.int64, device=device)
            * G % n_slices).to(torch.int32)


def decode_codes_cuda(words: torch.Tensor, table: torch.Tensor, *,
                      bits: int, count: int, n_slices: int = 1,
                      phases=None) -> torch.Tensor:
    """(n, W) int32 words + (n_slices*rows, F) float32 table on the card ->
    (count, F) rows."""
    G, W = packing_dims(bits)
    _require_cuda(words, "words", torch.int32)
    _require_cuda(table, "table", torch.float32)
    if words.dim() != 2 or words.shape[1] != W:
        raise ValueError(f"words must be (n, {W}) for {bits} bits, got "
                         f"{tuple(words.shape)}")
    n = words.shape[0]
    n_tab, F = table.shape
    if n_tab % n_slices:
        raise ValueError(f"table rows {n_tab} do not split into {n_slices} "
                         f"slices")
    if not 0 <= count <= n * G:
        raise ValueError(f"count {count} exceeds the {n * G} codes of the "
                         f"stream")
    if phases is None:
        phases = stream_phases(n, bits, n_slices, device=words.device)
    phases = torch.as_tensor(phases).reshape(-1)
    _require_cuda(phases, "phases", torch.int32)
    if phases.numel() != n:
        raise ValueError(f"{phases.numel()} phases for {n} word groups")
    out = torch.empty((count, F), dtype=torch.float32, device=words.device)
    if count:
        _build.check(_build.library().rt_decode_codes(
            words.data_ptr(), phases.data_ptr(), table.data_ptr(),
            out.data_ptr(), count, n_tab, F, n_tab // n_slices, n_slices,
            bits, words.get_device(), _build.stream_of(words)),
            "decode_codes")
    return out
