"""Fused decode of :class:`CodePayload` word streams — the ONE place the
record/phase bookkeeping lives.

Port of ``repro.wire.codec``. :func:`decode_payloads` decodes N payloads
of one bit width against one codebook in exactly ONE
``ops.decode_codes`` dispatch: the word streams are concatenated (every
record is padded to whole super-groups, so record boundaries sit on word
rows) with slice phases that restart at 0 for each record, and each
record's trailing pad rows are dropped afterwards.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels.pack_bits import packing_dims

from .payload import CodePayload


def packed_record_rows(payload_rows: int, bits: int, count: int,
                       n_records: int, rows: torch.Tensor,
                       table_dim: int) -> torch.Tensor:
    """(payload_rows * G, F) decode of a FULL multi-record stream -> the
    (count, F) real rows in stream order (each record's pad rows gone)."""
    rpr = payload_rows // n_records
    G, _ = packing_dims(bits)
    per = rows.reshape(n_records, rpr * G, table_dim)
    return per[:, :count // n_records].reshape(count, table_dim)


def payload_phases(p: CodePayload, n_slices: int) -> torch.Tensor:
    """Per-super-group slice phases of a (possibly multi-record) stream:
    each record's slice phase restarts at 0."""
    from repro_torch.kernels.decode_codes import stream_phases
    rows = int(p.payload.shape[0])
    return stream_phases(rows // p.n_records, p.bits, n_slices,
                         device=p.payload.device).repeat(p.n_records)


def feature_shape(cfg, shape: Tuple[int, ...], feat_dim: int
                  ) -> Tuple[int, ...]:
    """Decoded feature shape of an index array ``shape``. GSVQ shapes end
    with n_c; per-code rows are m-dim slice chunks whose row-major
    concatenation IS the (..., M) layout."""
    if cfg.n_groups > 1 or cfg.n_slices > 1:
        return tuple(shape[:-1]) + (int(shape[-1]) * int(feat_dim),)
    return tuple(shape) + (int(feat_dim),)


def decode_rows(p: CodePayload, table: torch.Tensor, *,
                n_slices: int = 1) -> torch.Tensor:
    """One payload -> its (count, F) real decoded rows, ONE dispatch."""
    from repro_torch.kernels.ops import decode_codes
    words = p.payload.to(table.device)
    if p.n_records == 1:
        return decode_codes(words, table, bits=p.bits, count=p.count,
                            n_slices=n_slices)
    G, _ = packing_dims(p.bits)
    n_rows = int(words.shape[0])
    rows = decode_codes(words, table, bits=p.bits, count=n_rows * G,
                        n_slices=n_slices,
                        phases=payload_phases(p, n_slices).to(table.device))
    return packed_record_rows(n_rows, p.bits, p.count, p.n_records, rows,
                              int(table.shape[-1]))


def decode_payloads(payloads: Sequence[CodePayload], cfg,
                    codebook: torch.Tensor) -> List[torch.Tensor]:
    """Decode N same-bits payloads against ONE codebook in exactly ONE
    fused dispatch. Returns per-payload feature blocks in the payloads'
    own index shapes (``feature_shape``)."""
    from repro_torch.core import octopus as OC
    from repro_torch.kernels.ops import decode_codes
    if not payloads:
        return []
    bits = payloads[0].bits
    if any(p.bits != bits for p in payloads):
        raise ValueError(
            f"one dispatch needs one packing width, got "
            f"{sorted({p.bits for p in payloads})} bits")
    table, n_slices = OC.decode_table(cfg, codebook)
    F = int(table.shape[-1])
    if len(payloads) == 1:
        p = payloads[0]
        return [decode_rows(p, table, n_slices=n_slices).reshape(
            feature_shape(cfg, p.shape, F))]
    G, _ = packing_dims(bits)
    spans, phases, row_off = [], [], 0
    for p in payloads:
        n_rows = int(p.payload.shape[0])
        phases.append(payload_phases(p, n_slices).to(table.device))
        spans.append((row_off, n_rows))
        row_off += n_rows
    rows = decode_codes(
        torch.cat([p.payload.to(table.device) for p in payloads], dim=0),
        table, bits=bits, count=row_off * G, n_slices=n_slices,
        phases=torch.cat(phases))
    out = []
    for (start, n_rows), p in zip(spans, payloads):
        f = packed_record_rows(n_rows, bits, p.count, p.n_records,
                               rows[start * G:(start + n_rows) * G], F)
        out.append(f.reshape(feature_shape(cfg, p.shape, F)))
    return out
