"""Versioned store of packed client payloads (Step 6's front door).

Port of the plain ``repro.server.store.CodeStore`` and its shared decode
path. Entries stay PACKED until a trainer asks for features; every entry
is a :class:`~repro_torch.wire.payload.CodePayload` keyed by its own
codebook version, so payloads that raced a Step 5 merge decode against
the snapshot they were packed under. Decoding is bulk: records are
grouped by (version, bits) and each group is one fused decode dispatch.
Unprivatized payloads are refused at the door (§2.5).

Capacity bounds with FIFO/reservoir eviction, snapshots and the sharded
store come with the server-runtime slice. While a flight recorder is
active, ``add`` sets the ``store_*`` gauges and every decode group logs a
``decode`` event and a ``decode_ms/v<version>`` observation.
"""
from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.dvqae import DVQAEConfig
from repro_torch.obs import recorder as _obs
from repro_torch.wire.payload import (DEFAULT_TASK, CodePayload,
                                      normalize_labels)


class StoreRecord(NamedTuple):
    """One buffered uplink: a wire payload plus its provenance."""
    packed: CodePayload
    client_ids: np.ndarray              # (C,) who sent these codes
    round: int                          # scheduler round it was SENT
    version: int                        # codebook version it was packed under
    labels: Optional[Dict[str, torch.Tensor]]   # task -> (C*B,) labels

    @property
    def n_samples(self) -> int:
        return int(self.packed.shape[0]) * int(self.packed.shape[1])


class CodeStore:
    """Lazily-decoded store of packed transmissions with a byte ledger."""

    def __init__(self, cfg: DVQAEConfig):
        self.cfg = cfg
        self._records: List[StoreRecord] = []
        self.ingested_records = 0
        self.ingested_samples = 0
        self.ingested_bytes = 0

    def __len__(self) -> int:
        return len(self._records)

    @property
    def records(self) -> Tuple[StoreRecord, ...]:
        return tuple(self._records)

    @property
    def n_samples(self) -> int:
        return sum(r.n_samples for r in self._records)

    @property
    def total_bytes(self) -> int:
        """Measured packed bytes currently held (§2.8 accounting)."""
        return sum(r.packed.nbytes for r in self._records)

    def add(self, packed: CodePayload, *, client_ids=None, round: int = 0
            ) -> StoreRecord:
        """Ingest one wire payload of shape (C, B, T[, n_c]) under its own
        codebook version; its labels are checked against the sample
        count HERE."""
        if packed.privatized is False:
            raise ValueError(
                "refusing a payload not marked privatized: only public Z• "
                "code indices may enter the store (§2.5)")
        if len(packed.shape) < 2:
            raise ValueError(f"packed payload must carry a (clients, batch) "
                             f"leading layout, got shape {packed.shape}")
        C, B = int(packed.shape[0]), int(packed.shape[1])
        if client_ids is None:
            client_ids = np.arange(C)
        client_ids = np.asarray(client_ids).reshape(-1)
        if client_ids.shape[0] != C:
            raise ValueError(f"client_ids has {client_ids.shape[0]} entries "
                             f"for {C} client rows in the payload")
        rec = StoreRecord(packed=packed, client_ids=client_ids,
                          round=int(round), version=int(packed.version),
                          labels=normalize_labels(packed.labels, C * B))
        self._records.append(rec)
        self.ingested_records += 1
        self.ingested_samples += rec.n_samples
        self.ingested_bytes += packed.nbytes
        ob = _obs.active()
        if ob is not None:
            ob.metrics.set_gauge("store_records", len(self._records))
            ob.metrics.set_gauge("store_samples", self.n_samples)
            ob.metrics.set_gauge("store_bytes", self.total_bytes)
        return rec

    def get(self, client_id: int, round: int) -> Tuple[torch.Tensor, int]:
        """ONE client's codes by (client_id, round):
        -> ((B, T[, n_c]) int32 indices, codebook version)."""
        for rec in self._records:
            if rec.round != round:
                continue
            pos = np.nonzero(rec.client_ids == client_id)[0]
            if pos.size:
                return rec.packed.unpack()[int(pos[0])], rec.version
        raise KeyError((client_id, round))

    def dataset(self, registry, *, version: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Bulk decode: ONE fused decode dispatch per codebook version,
        each against its ``registry`` snapshot. Returns
        (features (N, ...), {task: (N,) labels}) in record order."""
        return decode_records(self._records, self.cfg, registry,
                              version=version)


# ------------------------------------------------------- shared decode path

def labels_for(records, task: Optional[str] = None
               ) -> Optional[torch.Tensor]:
    """Concatenated labels for ``task`` over ``records`` (record order),
    or None if any record lacks them."""
    task = DEFAULT_TASK if task is None else task
    parts = []
    for r in records:
        if not r.labels or task not in r.labels:
            return None
        parts.append(r.labels[task])
    return torch.cat(parts) if parts else None


def label_dict_for(records) -> Dict[str, torch.Tensor]:
    """All tasks that every record carries -> {task: (N,) labels}."""
    names: Dict[str, None] = {}
    for r in records:
        for t in r.labels or ():
            names[t] = None
    out = {}
    for t in names:
        v = labels_for(records, t)
        if v is not None:
            out[t] = v
    return out


def decode_group(recs, cfg: DVQAEConfig, codebook: torch.Tensor
                 ) -> List[torch.Tensor]:
    """ONE fused decode dispatch for records packed under one version ->
    per-record (C*B, T..., M) feature blocks."""
    from repro_torch.wire.codec import decode_payloads
    blocks = decode_payloads([r.packed for r in recs], cfg, codebook)
    return [f.reshape((-1,) + tuple(f.shape[2:])) for f in blocks]


def decode_records(records, cfg: DVQAEConfig, registry, *,
                   version: Optional[int] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Bulk decode any record sequence: ONE fused dispatch per
    (codebook version, bit width) group, against the version's
    ``registry`` snapshot."""
    records = list(records)
    recs = [(i, r) for i, r in enumerate(records)
            if version is None or r.version == version]
    if not recs:
        raise ValueError("empty code store"
                         + (f" for version {version}" if version
                            is not None else ""))
    groups: Dict[Tuple[int, int], List[int]] = {}
    for i, r in recs:
        groups.setdefault((r.version, r.packed.bits), []).append(i)
    parts: Dict[int, torch.Tensor] = {}
    ob = _obs.active()
    for (v, _), idxs in groups.items():
        t0 = time.perf_counter() if ob is not None else 0.0
        blocks = decode_group([records[i] for i in idxs], cfg,
                              registry.get(v))
        if ob is not None:
            _obs.settle(*blocks)
            dur_ms = (time.perf_counter() - t0) * 1e3
            ob.event("decode", version=int(v), dur_ms=dur_ms,
                     n_records=len(idxs),
                     n_samples=int(sum(b.shape[0] for b in blocks)))
            ob.metrics.observe(f"decode_ms/v{int(v)}", dur_ms)
        parts.update(zip(idxs, blocks))
    feats = torch.cat([parts[i] for i, _ in recs], dim=0)
    return feats, label_dict_for([r for _, r in recs])
