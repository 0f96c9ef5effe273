"""Versioned, capacity-bounded stores of packed client payloads.

Port of ``repro.server.store``: Step 6's front door. ``CodeStore`` is one
bounded ring buffer; ``ShardedCodeStore`` partitions the traffic into
independent ring buffers keyed by ``(codebook version, client shard)``.

  * entries stay PACKED until a trainer asks for features;
  * every entry is a :class:`~repro_torch.wire.payload.CodePayload` keyed
    by its own codebook version, so payloads that raced a Step 5 merge
    decode against the registry snapshot they were packed under;
  * payloads not marked ``privatized`` are refused at the door (§2.5);
  * a sample-count capacity with FIFO or Algorithm-R reservoir eviction
    (``np.random.default_rng(seed)``, the reference's draws) bounds the
    store; per-version byte ledgers keep Σ stored + Σ evicted == Σ
    ingested for every version (§2.8);
  * decoding is BULK: records are grouped by (version, bits) and each
    group is one fused decode dispatch.

``snapshot_state`` / ``load_state`` use the reference's manifest and array
layout (words as uint32), so a snapshot from either package loads into the
other. While a flight recorder is active, ``add`` sets the ``store_*``
gauges and every decode group logs a ``decode`` event and a
``decode_ms/v<version>`` observation.
"""
from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.dvqae import DVQAEConfig
from repro_torch.obs import recorder as _obs
from repro_torch.wire.payload import (DEFAULT_TASK, CodePayload, LabelsLike,
                                      normalize_labels)

POLICIES = ("fifo", "reservoir")


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


def _check_policy(policy: str) -> None:
    if policy not in POLICIES:
        raise ValueError(f"policy must be fifo|reservoir, got {policy!r}")


def _empty(version: Optional[int]) -> ValueError:
    return ValueError("empty code store" + (
        f" for version {version}" if version is not None else ""))


def _codes_of(records, version: Optional[int]) -> torch.Tensor:
    """Unpacked codes of ``records`` (filtered to ``version``), the client
    axis merged -> (N, T[, n_c]) int32 in record order."""
    recs = [r for r in records if version is None or r.version == version]
    if not recs:
        raise _empty(version)
    parts = []
    for r in recs:
        idx = r.packed.unpack()
        parts.append(idx.reshape((-1,) + tuple(idx.shape[2:])))
    return torch.cat(parts, dim=0)


def _minibatches(feats, labels, batch_size: int, generator, steps: int):
    """``steps`` minibatches of (features, {task: labels}) drawn with
    replacement from ``generator``."""
    n = feats.shape[0]
    for _ in range(steps):
        sel = torch.randint(0, n, (min(batch_size, n),),
                            generator=generator).to(feats.device)
        yield feats[sel], {t: y[sel.to(y.device)] for t, y in labels.items()}


class CodeStore:
    """Capacity-bounded, lazily-decoded store of packed transmissions."""

    def __init__(self, cfg: DVQAEConfig, *,
                 capacity_samples: Optional[int] = None,
                 policy: str = "fifo", seed: int = 0):
        _check_policy(policy)
        self.cfg = cfg
        self.capacity_samples = capacity_samples
        self.policy = policy
        self._rng = np.random.default_rng(seed)
        self._records: List[StoreRecord] = []
        self._seen_records = 0            # total ever added (reservoir)
        self.evicted_samples = 0
        self.evicted_records = 0
        self.evicted_bytes = 0
        self.ingested_records = 0
        self.ingested_samples = 0
        self.ingested_bytes = 0
        # per-version byte ledgers: stored + evicted == ingested, always
        self._ingested_by_version: Dict[int, int] = {}
        self._evicted_by_version: Dict[int, int] = {}

    # ----------------------------------------------------------- metadata

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

    @property
    def versions(self) -> Tuple[int, ...]:
        return tuple(sorted({r.version for r in self._records}))

    @property
    def tasks(self) -> Tuple[str, ...]:
        names: Dict[str, None] = {}
        for r in self._records:
            for t in r.labels or ():
                names[t] = None
        return tuple(names)

    # ---------------------------------------------------------------- add

    def add(self, packed: CodePayload, *, client_ids=None, round: int = 0,
            version: Optional[int] = None, labels: LabelsLike = None
            ) -> StoreRecord:
        """Ingest one wire payload of shape (C, B, T[, n_c]).
        ``client_ids`` (C,) default to 0..C-1, ``version`` to the payload's
        own, ``labels`` to the payload's own channels, checked against the
        sample count HERE."""
        if getattr(packed, "privatized", True) is False:
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
        if version is None:
            version = int(getattr(packed, "version", 0))
        if labels is None:
            labels = getattr(packed, "labels", None)
        rec = StoreRecord(packed=packed, client_ids=client_ids,
                          round=int(round), version=int(version),
                          labels=normalize_labels(labels, C * B))
        self._records.append(rec)
        self._seen_records += 1
        nb = packed.nbytes
        self.ingested_records += 1
        self.ingested_samples += rec.n_samples
        self.ingested_bytes += nb
        v = rec.version
        self._ingested_by_version[v] = self._ingested_by_version.get(v, 0) + nb
        self._evict()
        self._set_gauges()
        return rec

    def _evict(self) -> None:
        if self.capacity_samples is None:
            return
        while self.n_samples > self.capacity_samples \
                and len(self._records) > 1:
            if self.policy == "fifo":
                victim = 0
            else:
                # Algorithm R over records: the INCOMING record is kept with
                # prob slots/seen (replacing a uniform old record), else it
                # is the one rejected
                slots = len(self._records) - 1
                if self._rng.random() < slots / self._seen_records:
                    victim = int(self._rng.integers(0, slots))
                else:
                    victim = len(self._records) - 1
            self._charge_eviction(self._records.pop(victim))

    def _charge_eviction(self, rec: StoreRecord) -> None:
        nb = rec.packed.nbytes
        self.evicted_samples += rec.n_samples
        self.evicted_records += 1
        self.evicted_bytes += nb
        v = rec.version
        self._evicted_by_version[v] = self._evicted_by_version.get(v, 0) + nb

    def _set_gauges(self) -> None:
        ob = _obs.active()
        if ob is not None:
            ob.metrics.set_gauge("store_records", len(self._records))
            ob.metrics.set_gauge("store_samples", self.n_samples)
            ob.metrics.set_gauge("store_bytes", self.total_bytes)

    # ------------------------------------------------------------- ledgers

    @property
    def ingested_bytes_by_version(self) -> Dict[int, int]:
        return dict(self._ingested_by_version)

    @property
    def evicted_bytes_by_version(self) -> Dict[int, int]:
        return dict(self._evicted_by_version)

    @property
    def stored_bytes_by_version(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for r in self._records:
            out[r.version] = out.get(r.version, 0) + r.packed.nbytes
        return out

    def retire_version(self, version: int) -> Tuple[StoreRecord, ...]:
        """Evict EVERY record packed under ``version`` (the migration
        retire and re-encode paths); the bytes stay on the per-version
        ledger. Returns the retired records."""
        version = int(version)
        keep, gone = [], []
        for r in self._records:
            (gone if r.version == version else keep).append(r)
        self._records = keep
        for r in gone:
            self._charge_eviction(r)
        self._set_gauges()
        return tuple(gone)

    # ---------------------------------------------------------- durability

    def snapshot_state(self) -> Tuple[dict, Dict[str, np.ndarray]]:
        """Durable state -> (JSON-able manifest, {key: numpy array}): the
        ring's words (uint32) and metadata, provenance, every ledger
        counter and the reservoir Generator's state."""
        arrays: Dict[str, np.ndarray] = {}
        recs = []
        for i, r in enumerate(self._records):
            p = r.packed
            arrays[f"r{i}.words"] = \
                p.payload.detach().cpu().numpy().view(np.uint32)
            arrays[f"r{i}.client_ids"] = np.asarray(r.client_ids)
            tasks = sorted(r.labels) if r.labels else []
            for t in tasks:
                arrays[f"r{i}.label.{t}"] = r.labels[t].detach().cpu().numpy()
            recs.append({
                "round": int(r.round), "version": int(r.version),
                "bits": int(p.bits), "shape": list(p.shape),
                "n_records": int(p.n_records),
                "payload_version": int(p.version),
                "privatized": bool(p.privatized), "wire": int(p.wire),
                "checksum": None if p.checksum is None else int(p.checksum),
                "tasks": tasks,
            })
        manifest = {
            "kind": "single",
            "policy": self.policy,
            "capacity_samples": self.capacity_samples,
            "seen_records": int(self._seen_records),
            "evicted": [int(self.evicted_samples), int(self.evicted_records),
                        int(self.evicted_bytes)],
            "ingested": [int(self.ingested_records),
                         int(self.ingested_samples),
                         int(self.ingested_bytes)],
            "ingested_by_version": {str(v): int(n) for v, n
                                    in self._ingested_by_version.items()},
            "evicted_by_version": {str(v): int(n) for v, n
                                   in self._evicted_by_version.items()},
            "rng_state": self._rng.bit_generator.state,
            "records": recs,
        }
        return manifest, arrays

    def load_state(self, manifest: dict, arrays: Dict[str, np.ndarray], *,
                   device=None) -> "CodeStore":
        """Restore :meth:`snapshot_state` output (from either package) into
        this fresh store, its words and labels on ``device`` (cuda unless
        the caller passes ``device="cpu"``)."""
        from repro_torch import resolve_device
        dev = resolve_device(device)
        self.policy = manifest["policy"]
        self.capacity_samples = manifest["capacity_samples"]
        self._seen_records = int(manifest["seen_records"])
        (self.evicted_samples, self.evicted_records,
         self.evicted_bytes) = [int(x) for x in manifest["evicted"]]
        (self.ingested_records, self.ingested_samples,
         self.ingested_bytes) = [int(x) for x in manifest["ingested"]]
        self._ingested_by_version = {
            int(v): int(n) for v, n in manifest["ingested_by_version"].items()}
        self._evicted_by_version = {
            int(v): int(n) for v, n in manifest["evicted_by_version"].items()}
        self._rng.bit_generator.state = manifest["rng_state"]
        self._records = []
        for i, m in enumerate(manifest["records"]):
            labels = {t: torch.as_tensor(np.array(arrays[f"r{i}.label.{t}"]),
                                         device=dev)
                      for t in m["tasks"]} or None
            words = np.ascontiguousarray(
                np.asarray(arrays[f"r{i}.words"])).view(np.int32)
            p = CodePayload(payload=torch.from_numpy(words.copy()).to(dev),
                            bits=int(m["bits"]), shape=tuple(m["shape"]),
                            n_records=int(m["n_records"]),
                            version=int(m["payload_version"]), labels=labels,
                            privatized=bool(m["privatized"]),
                            wire=int(m["wire"]),
                            checksum=(None if m["checksum"] is None
                                      else int(m["checksum"])))
            self._records.append(StoreRecord(
                packed=p, client_ids=np.asarray(arrays[f"r{i}.client_ids"]),
                round=int(m["round"]), version=int(m["version"]),
                labels=labels))
        return self

    # ------------------------------------------------------------- lookup

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

    # ------------------------------------------------------------- decode

    def codes(self, version: Optional[int] = None) -> torch.Tensor:
        """Unpack buffered records -> (N, T[, n_c]) int32, record order;
        ``version`` filters to codes packed under that version."""
        return _codes_of(self._records, version)

    def labels(self, task: Optional[str] = None, *, records=None
               ) -> Optional[torch.Tensor]:
        """Concatenated labels for ``task`` (record order), or None if any
        record lacks them; ``records`` restricts to a subset."""
        return labels_for(self._records if records is None else records,
                          task)

    def label_dict(self, *, records=None) -> Dict[str, torch.Tensor]:
        """All tasks that every record carries -> {task: (N,) labels}."""
        return label_dict_for(self._records if records is None else records)

    def dataset(self, server=None, *, registry=None,
                version: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Bulk decode: ONE fused decode dispatch per (version, bits)
        group, each against its ``registry`` snapshot (without a registry,
        against the server's current codebook). Returns (features (N,
        ...), {task: (N,) labels}) in record order."""
        return decode_records(self._records, self.cfg, server,
                              registry=registry, version=version)

    def batches(self, server, batch_size: int, *,
                generator: torch.Generator, steps: int, registry=None):
        """Minibatch stream over the decoded store (decoded ONCE), rows
        drawn with replacement from ``generator``."""
        feats, labels = self.dataset(server, registry=registry)
        return _minibatches(feats, labels, batch_size, generator, steps)


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


def decode_group(recs, cfg: DVQAEConfig, server, codebook=None
                 ) -> List[torch.Tensor]:
    """ONE fused decode dispatch for records packed under one version,
    against ``codebook`` (the server's current one when None) ->
    per-record (C*B, T..., M) feature blocks."""
    from repro_torch.wire.codec import decode_payloads
    if codebook is None:
        if server is None:
            raise ValueError("decode needs a ServerState or a registry "
                             "to decode against")
        codebook = server.params["codebook"]
    blocks = decode_payloads([r.packed for r in recs], cfg, codebook)
    return [f.reshape((-1,) + tuple(f.shape[2:])) for f in blocks]


def decode_records(records, cfg: DVQAEConfig, server=None, *, registry=None,
                   version: Optional[int] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Bulk decode any record sequence: ONE fused dispatch per
    (codebook version, bit width) group, each against its pinned registry
    snapshot when a ``registry`` is given."""
    records = list(records)
    recs = [(i, r) for i, r in enumerate(records)
            if version is None or r.version == version]
    if not recs:
        raise _empty(version)
    groups: Dict[Tuple[int, int], List[int]] = {}
    for i, r in recs:
        groups.setdefault((r.version, r.packed.bits), []).append(i)
    parts: Dict[int, torch.Tensor] = {}
    ob = _obs.active()
    for (v, _), idxs in groups.items():
        cb = registry.get(v) if registry is not None else None
        t0 = time.perf_counter() if ob is not None else 0.0
        blocks = decode_group([records[i] for i in idxs], cfg, server, cb)
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


# ------------------------------------------------------------ sharded store

class ShardedCodeStore:
    """``(codebook version, client shard)``-partitioned ring buffers.

    Each partition is an independent :class:`CodeStore` with its OWN
    ``capacity_samples`` bound and eviction policy, created on first
    traffic; emptied partitions stay registered so their ledgers keep
    witnessing retired bytes. ``shard_fn`` maps a ``client_ids`` array to
    a shard; the default is the first client id modulo ``n_shards``.
    """

    def __init__(self, cfg: DVQAEConfig, *, n_shards: int = 4,
                 capacity_samples: Optional[int] = None,
                 policy: str = "fifo", seed: int = 0, shard_fn=None):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        _check_policy(policy)
        self.cfg = cfg
        self.n_shards = int(n_shards)
        self.capacity_samples = capacity_samples
        self.policy = policy
        self.seed = int(seed)
        self.shard_fn = shard_fn
        self._parts: Dict[Tuple[int, int], CodeStore] = {}

    # -------------------------------------------------------- partitioning

    def shard_of(self, client_ids) -> int:
        if self.shard_fn is not None:
            return int(self.shard_fn(client_ids)) % self.n_shards
        if client_ids is None:
            return 0
        ids = np.asarray(client_ids).reshape(-1)
        if ids.size == 0:
            return 0
        return int(ids[0]) % self.n_shards

    def partition(self, version: int, shard: int) -> CodeStore:
        k = (int(version), int(shard))
        part = self._parts.get(k)
        if part is None:
            # deterministic per-partition reservoir streams
            pseed = (self.seed * 1000003 + k[0] * 8191 + k[1]) & 0x7FFFFFFF
            part = CodeStore(self.cfg,
                             capacity_samples=self.capacity_samples,
                             policy=self.policy, seed=pseed)
            self._parts[k] = part
        return part

    @property
    def partitions(self) -> Dict[Tuple[int, int], CodeStore]:
        return dict(self._parts)

    def _ordered_parts(self) -> List[CodeStore]:
        return [self._parts[k] for k in sorted(self._parts)]

    # ---------------------------------------------------------------- add

    def add(self, packed: CodePayload, *, client_ids=None, round: int = 0,
            version: Optional[int] = None, labels: LabelsLike = None
            ) -> StoreRecord:
        if version is None:
            version = int(getattr(packed, "version", 0))
        rec = self.partition(version, self.shard_of(client_ids)).add(
            packed, client_ids=client_ids, round=round, version=version,
            labels=labels)
        self._set_gauges()
        return rec

    def _set_gauges(self) -> None:
        ob = _obs.active()
        if ob is not None:
            ob.metrics.set_gauge("store_records", len(self))
            ob.metrics.set_gauge("store_samples", self.n_samples)
            ob.metrics.set_gauge("store_bytes", self.total_bytes)
            ob.metrics.set_gauge("store_partitions", len(self._parts))

    # ----------------------------------------------------------- metadata

    def __len__(self) -> int:
        return sum(len(p) for p in self._parts.values())

    @property
    def records(self) -> Tuple[StoreRecord, ...]:
        """All records, in sorted (version, shard) partition order."""
        out: List[StoreRecord] = []
        for p in self._ordered_parts():
            out.extend(p.records)
        return tuple(out)

    @property
    def n_samples(self) -> int:
        return sum(p.n_samples for p in self._parts.values())

    @property
    def total_bytes(self) -> int:
        return sum(p.total_bytes for p in self._parts.values())

    @property
    def versions(self) -> Tuple[int, ...]:
        return tuple(sorted({v for p in self._parts.values()
                             for v in p.versions}))

    @property
    def tasks(self) -> Tuple[str, ...]:
        names: Dict[str, None] = {}
        for p in self._ordered_parts():
            for t in p.tasks:
                names[t] = None
        return tuple(names)

    # ------------------------------------------------------------- ledgers

    @property
    def ingested_bytes(self) -> int:
        return sum(p.ingested_bytes for p in self._parts.values())

    @property
    def evicted_bytes(self) -> int:
        return sum(p.evicted_bytes for p in self._parts.values())

    @property
    def evicted_records(self) -> int:
        return sum(p.evicted_records for p in self._parts.values())

    @property
    def evicted_samples(self) -> int:
        return sum(p.evicted_samples for p in self._parts.values())

    def _sum_by_version(self, attr: str) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for p in self._parts.values():
            for v, nb in getattr(p, attr).items():
                out[v] = out.get(v, 0) + nb
        return out

    @property
    def ingested_bytes_by_version(self) -> Dict[int, int]:
        return self._sum_by_version("ingested_bytes_by_version")

    @property
    def evicted_bytes_by_version(self) -> Dict[int, int]:
        return self._sum_by_version("evicted_bytes_by_version")

    @property
    def stored_bytes_by_version(self) -> Dict[int, int]:
        return self._sum_by_version("stored_bytes_by_version")

    def retire_version(self, version: int) -> Tuple[StoreRecord, ...]:
        """Evict every record of ``version`` across all shards."""
        gone: List[StoreRecord] = []
        for k in sorted(self._parts):
            if k[0] == int(version):
                gone.extend(self._parts[k].retire_version(version))
        self._set_gauges()
        return tuple(gone)

    # ---------------------------------------------------------- durability

    def snapshot_state(self) -> Tuple[dict, Dict[str, np.ndarray]]:
        """Durable state across ALL partitions, array keys prefixed
        ``p<version>.<shard>.`` so one flat npz holds the whole store."""
        arrays: Dict[str, np.ndarray] = {}
        parts = []
        for (v, s) in sorted(self._parts):
            man, arr = self._parts[(v, s)].snapshot_state()
            prefix = f"p{v}.{s}."
            arrays.update({prefix + k: a for k, a in arr.items()})
            parts.append({"version": int(v), "shard": int(s),
                          "manifest": man})
        manifest = {"kind": "sharded", "n_shards": int(self.n_shards),
                    "capacity_samples": self.capacity_samples,
                    "policy": self.policy, "seed": int(self.seed),
                    "partitions": parts}
        return manifest, arrays

    def load_state(self, manifest: dict, arrays: Dict[str, np.ndarray], *,
                   device=None) -> "ShardedCodeStore":
        """Restore :meth:`snapshot_state` output into this fresh store.
        ``shard_fn`` is routing code, not state: pass it to the
        constructor as on the original deployment."""
        self.n_shards = int(manifest["n_shards"])
        self.capacity_samples = manifest["capacity_samples"]
        self.policy = manifest["policy"]
        self.seed = int(manifest["seed"])
        self._parts = {}
        for pm in manifest["partitions"]:
            v, s = int(pm["version"]), int(pm["shard"])
            prefix = f"p{v}.{s}."
            sub = {k[len(prefix):]: a for k, a in arrays.items()
                   if k.startswith(prefix)}
            self.partition(v, s).load_state(pm["manifest"], sub,
                                            device=device)
        return self

    # ------------------------------------------------------------- lookup

    def get(self, client_id: int, round: int) -> Tuple[torch.Tensor, int]:
        for p in self._ordered_parts():
            try:
                return p.get(client_id, round)
            except KeyError:
                continue
        raise KeyError((client_id, round))

    # ------------------------------------------------------------- decode

    def codes(self, version: Optional[int] = None) -> torch.Tensor:
        return _codes_of(self.records, version)

    def labels(self, task: Optional[str] = None, *, records=None
               ) -> Optional[torch.Tensor]:
        return labels_for(self.records if records is None else records,
                          task)

    def label_dict(self, *, records=None) -> Dict[str, torch.Tensor]:
        return label_dict_for(self.records if records is None else records)

    def dataset(self, server=None, *, registry=None,
                version: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Bulk decode across all partitions: still ONE fused dispatch per
        (version, bits) group; sharding changes residency, not batching."""
        return decode_records(self.records, self.cfg, server,
                              registry=registry, version=version)

    def batches(self, server, batch_size: int, *,
                generator: torch.Generator, steps: int, registry=None):
        feats, labels = self.dataset(server, registry=registry)
        return _minibatches(feats, labels, batch_size, generator, steps)
