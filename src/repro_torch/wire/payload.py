"""The OCTOPUS wire format: ONE versioned carrier for the code stream.

Port of ``repro.wire.payload``. A :class:`CodePayload` holds the dense
packed word stream (an int32 tensor carrying the uint32 bit pattern, so
``nbytes`` is ``numel * 4``, the §2.8 byte accounting), the bits per
code, the index shape, the number of per-record streams, the codebook
version, optional per-task labels, the §2.5 ``privatized`` flag, the
wire revision and a CRC32 over the words and the decode-steering
metadata. The CRC is byte-identical to the reference's, so payloads
cross between the two packages in both directions.
"""
from __future__ import annotations

import math
import zlib
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels.pack_bits import packing_dims
from repro_torch.kernels.ref import pad_records

#: current wire revision: 2 added the CRC32 integrity checksum
WIRE_VERSION = 2

#: revisions the server side still admits; revision 1 has no checksum
SUPPORTED_WIRE_VERSIONS = (1, 2)

DEFAULT_TASK = "label"

LabelsLike = Union[None, torch.Tensor, np.ndarray, Dict[str, Any]]


def _words_bytes(words) -> bytes:
    """Little-endian uint32 bytes of a word stream (tensor or array)."""
    if isinstance(words, torch.Tensor):
        words = words.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(words).view(np.uint32)).tobytes()


def payload_crc(words, *, bits: int, shape, n_records: int,
                version: int) -> int:
    """CRC32 over the decode-steering header and the packed word bytes:
    ``f"{bits}|{shape}|{n_records}|{version}"`` with the shape a tuple of
    Python ints, then the words as little-endian uint32."""
    header = (f"{int(bits)}|{tuple(int(d) for d in shape)}|"
              f"{int(n_records)}|{int(version)}").encode()
    return zlib.crc32(_words_bytes(words), zlib.crc32(header)) & 0xFFFFFFFF


def normalize_labels(labels: LabelsLike, n: Optional[int] = None
                     ) -> Optional[Dict[str, torch.Tensor]]:
    """dict/array/None -> ``{task: flat (n,) tensor}``, each channel
    checked against the payload's sample count when ``n`` is given."""
    if labels is None:
        return None
    if not isinstance(labels, dict):
        labels = {DEFAULT_TASK: labels}
    out = {}
    for task, arr in labels.items():
        arr = torch.as_tensor(arr)
        if n is not None and arr.numel() != n:
            raise ValueError(
                f"labels[{task!r}] has {arr.numel()} entries but the packed "
                f"payload carries {n} samples (shape mismatch caught at "
                f"pack/add, not decode)")
        out[task] = arr.reshape(-1)
    return out


def _int_codes(indices) -> torch.Tensor:
    idx = torch.as_tensor(indices)
    if idx.dtype.is_floating_point or idx.dtype.is_complex \
            or idx.dtype == torch.bool:
        raise TypeError(
            f"CodePayload carries quantized code indices, got dtype "
            f"{idx.dtype}; float latents (e.g. the private residual Z∘) "
            f"are structurally untransmittable (§2.5)")
    return idx


class CodePayload(NamedTuple):
    """One uplink on the wire: packed public code indices + provenance."""
    payload: torch.Tensor        # (rows, W) int32 packed word stream
    bits: int                    # bits per transmitted code
    shape: Tuple[int, ...]       # original index shape (C, B, T[, n_c])
    n_records: int = 1           # per-record streams concatenated in payload
    version: int = 0             # codebook version the codes were packed under
    labels: Optional[Dict[str, torch.Tensor]] = None   # task -> flat labels
    privatized: bool = True      # only public Z• indices on the wire (§2.5)
    wire: int = WIRE_VERSION     # wire-format revision
    checksum: Optional[int] = None   # CRC32 over words + metadata (rev 2)

    @property
    def nbytes(self) -> int:
        """MEASURED size of the buffer that crosses the network (§2.8)."""
        return int(self.payload.numel()) * self.payload.element_size()

    @property
    def count(self) -> int:
        """Number of real (non-padding) codes across all records."""
        return int(math.prod(self.shape))

    @property
    def expected_rows(self) -> int:
        """Minimum word rows the declared shape needs (each record padded
        to whole super-groups); fewer means the stream was cut."""
        G, _ = packing_dims(self.bits)
        if self.n_records == 1:
            return (self.count + G - 1) // G
        per = self.count // self.n_records
        return self.n_records * ((per + G - 1) // G)

    def stamped(self) -> "CodePayload":
        """Stamp (or refresh) the CRC32 from the words + metadata."""
        return self._replace(checksum=payload_crc(
            self.payload, bits=self.bits, shape=self.shape,
            n_records=self.n_records, version=self.version))

    def verify(self) -> bool:
        """Admission-door integrity check: enough word rows for the
        declared shape, and a matching CRC when one rides along."""
        if self.payload.dim() != 2 \
                or int(self.payload.shape[0]) < self.expected_rows:
            return False
        if self.checksum is None:
            return True
        crc = payload_crc(self.payload, bits=self.bits, shape=self.shape,
                          n_records=self.n_records, version=self.version)
        return crc == int(self.checksum)

    @classmethod
    def pack(cls, indices, *, bits: int, version: int = 0,
             labels: LabelsLike = None, n_samples: Optional[int] = None,
             privatized: bool = True) -> "CodePayload":
        """Pack an int code tensor into ONE contiguous word stream. Float
        inputs are refused: only quantized code indices cross the wire."""
        from repro_torch.kernels.ops import pack_codes
        idx = _int_codes(indices)
        words = pack_codes(idx, bits=bits)
        return cls(payload=words, bits=int(bits),
                   shape=tuple(int(d) for d in idx.shape), n_records=1,
                   version=int(version),
                   labels=normalize_labels(labels, n_samples),
                   privatized=bool(privatized)).stamped()

    @classmethod
    def pack_records(cls, indices, *, bits: int, version: int = 0,
                     labels: LabelsLike = None,
                     n_samples: Optional[int] = None,
                     privatized: bool = True) -> "CodePayload":
        """Pack ``indices`` (R, ...) as R per-record streams, each padded
        to whole super-groups, in ONE dispatch."""
        from repro_torch.kernels.ops import pack_codes
        idx = _int_codes(indices)
        flat = pad_records(idx.reshape(idx.shape[0], -1), bits)
        words = pack_codes(flat, bits=bits)
        return cls(payload=words, bits=int(bits),
                   shape=tuple(int(d) for d in idx.shape),
                   n_records=int(idx.shape[0]), version=int(version),
                   labels=normalize_labels(labels, n_samples),
                   privatized=bool(privatized)).stamped()

    @classmethod
    def from_words(cls, words, *, bits: int, shape, n_records: int = 1,
                   version: int = 0, labels: LabelsLike = None,
                   n_samples: Optional[int] = None,
                   privatized: bool = True) -> "CodePayload":
        """Wrap an already-packed word stream (e.g. straight from
        ``ops.encode_codes``) without touching the bytes."""
        return cls(payload=words, bits=int(bits),
                   shape=tuple(int(d) for d in shape),
                   n_records=int(n_records), version=int(version),
                   labels=normalize_labels(labels, n_samples),
                   privatized=bool(privatized)).stamped()

    def unpack(self) -> torch.Tensor:
        """Bit-exact inverse: -> int32 indices of the original shape."""
        from repro_torch.kernels.ops import unpack_codes
        if self.n_records == 1:
            return unpack_codes(self.payload, bits=self.bits,
                                count=self.count).reshape(self.shape)
        G, _ = packing_dims(self.bits)
        rows = int(self.payload.shape[0])
        flat = unpack_codes(self.payload, bits=self.bits, count=rows * G)
        per = flat.reshape(self.n_records, (rows // self.n_records) * G)
        return per[:, :self.count // self.n_records].reshape(self.shape)


def concat_payloads(payloads) -> CodePayload:
    """Concatenate per-record payloads into ONE carrier, byte-preserving:
    every record is padded to whole super-groups on its own, so stacking
    the word rows is the single whole-population payload. Metadata must
    agree, and labels must ride on every payload or on none."""
    ps = list(payloads)
    if not ps:
        raise ValueError("concat_payloads needs at least one payload")
    head = ps[0]
    for p in ps[1:]:
        if (p.bits, p.wire, p.version, p.privatized) != (
                head.bits, head.wire, head.version, head.privatized):
            raise ValueError(
                f"payload metadata mismatch: "
                f"{(p.bits, p.wire, p.version, p.privatized)} vs "
                f"{(head.bits, head.wire, head.version, head.privatized)}")
        if p.shape[1:] != head.shape[1:]:
            raise ValueError(f"per-record shape mismatch: {p.shape} vs "
                             f"{head.shape}")
    labeled = [p.labels is not None for p in ps]
    if any(labeled) and not all(labeled):
        raise ValueError(
            f"label channel mismatch: {sum(labeled)}/{len(ps)} payloads "
            f"carry labels — every record must be labeled, or none")
    labels = None
    if all(labeled):
        tasks = set(head.labels)
        for p in ps[1:]:
            if set(p.labels) != tasks:
                raise ValueError(
                    f"label task-channel mismatch: {sorted(p.labels)} vs "
                    f"{sorted(tasks)}")
        labels = {t: torch.cat([p.labels[t] for p in ps]) for t in tasks}
    if len(ps) == 1:
        return head
    words = torch.cat([p.payload for p in ps], dim=0)
    shape = (sum(p.shape[0] for p in ps),) + tuple(head.shape[1:])
    out = CodePayload(payload=words, bits=head.bits, shape=shape,
                      n_records=sum(p.n_records for p in ps),
                      version=head.version, labels=labels,
                      privatized=head.privatized, wire=head.wire)
    if all(p.checksum is not None for p in ps):
        out = out.stamped()
    return out
