"""Crash-consistent persistence for the continuous-ingest service.

Port of ``repro.server.persist``, with its directory layout, journal
schema and manifest keys, so either package recovers a directory the
other wrote. Two planes under one directory:

  * an APPEND-ONLY JOURNAL (``journal.jsonl``) of every state-mutating
    operation: admitted offers (packed words, the carrier's metadata and
    envelope), refusals (their ledger deltas), ticks, Step 5 merges (the
    post-merge dictionary), migration begin/complete ops and queue
    reorders, flushed per entry, so a kill loses at most a torn final
    line;
  * PERIODIC SNAPSHOTS of the durable state: the (sharded) store's rings,
    ledgers and reservoir generators, every registry snapshot and any OPEN
    migration window, the uplink queue (pending payloads and the §2.8 byte
    ledger), the dedup window, the admission histograms, and the server
    state in the reference's ``.state.npz`` layout
    (``checkpoint.npz.save_server_state``). The JSON manifest is written
    LAST with an atomic rename: a snapshot exists completely or not at all.

``ContinuousIngestService.recover`` = latest snapshot + the journal tail
replayed through the normal offer/tick/merge/migration paths.

Word streams are journaled and snapshotted as uint32, the reference's
dtype; the port reads them back as int32 words with the same bits.
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.journal import (Journal, decode_array,
                                            decode_words, encode_array,
                                            encode_words)
from repro_torch.checkpoint.npz import load_server_state, save_server_state
from repro_torch.wire.payload import CodePayload


# ------------------------------------------------------ payload (de)coding

def _payload_manifest(p: CodePayload) -> dict:
    return {"bits": int(p.bits), "shape": list(p.shape),
            "n_records": int(p.n_records), "version": int(p.version),
            "privatized": bool(p.privatized), "wire": int(p.wire),
            "checksum": p.checksum if p.checksum is None
            else int(p.checksum),
            "tasks": sorted(p.labels) if p.labels else []}


def _host_words(words: torch.Tensor) -> np.ndarray:
    """int32 words (any device) -> their uint32 bit pattern on the host."""
    return words.detach().cpu().numpy().view(np.uint32)


def _payload_from(m: dict, get, device) -> CodePayload:
    """Rebuild a carrier on ``device`` from its manifest and an array
    getter (``get("words")`` / ``get("label.<task>")`` -> numpy)."""
    labels = {t: torch.as_tensor(np.array(get(f"label.{t}")), device=device)
              for t in m["tasks"]} or None
    words = np.ascontiguousarray(get("words")).view(np.int32)
    return CodePayload(
        payload=torch.from_numpy(words.copy()).to(device),
        bits=int(m["bits"]), shape=tuple(m["shape"]),
        n_records=int(m["n_records"]), version=int(m["version"]),
        labels=labels, privatized=bool(m["privatized"]), wire=int(m["wire"]),
        checksum=None if m["checksum"] is None else int(m["checksum"]))


def _ids_list(client_ids) -> Optional[list]:
    if client_ids is None:
        return None
    return [int(c) for c in np.asarray(client_ids).reshape(-1)]


def _write_atomic(root: str, path: str, suffix: str, write) -> None:
    fd, tmp = tempfile.mkstemp(dir=root, suffix=suffix)
    os.close(fd)
    try:
        write(tmp)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


class ServerPersistence:
    """Journal + snapshot plane for ONE service directory.

    ``snapshot_every`` = service ticks between snapshots (0 = only the
    construction-time snapshot 0); ``keep`` = snapshots retained (the
    journal is never pruned: it is the ground truth the snapshots
    accelerate). ``resume=True`` reopens an existing directory for
    appending (what :meth:`ContinuousIngestService.recover` does).
    """

    def __init__(self, root: str, *, snapshot_every: int = 0,
                 keep: int = 3, resume: bool = False):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.snapshot_every = int(snapshot_every)
        self.keep = int(keep)
        self.journal = Journal(os.path.join(root, "journal.jsonl"),
                               resume=resume)

    # ----------------------------------------------------- journal writers

    def log_offer(self, p: CodePayload, *, client_ids=None, delay: int = 0,
                  uplink_id=None) -> None:
        entry = {"kind": "offer", "delay": int(delay),
                 "uplink_id": (None if uplink_id is None
                               else [int(uplink_id[0]), int(uplink_id[1])]),
                 "client_ids": _ids_list(client_ids),
                 "payload": _payload_manifest(p),
                 "words": encode_words(p.payload)}
        if p.labels:
            entry["labels"] = {t: encode_array(y)
                               for t, y in p.labels.items()}
        self.journal.append(entry)

    def log_tick(self) -> None:
        self.journal.append({"kind": "tick"})

    def log_reorder(self) -> None:
        """The two most recently queued payloads swapped delivery order.
        The reference journals no such entry (and its ``recover`` skips
        kinds it does not know), so its replay delivers them in offer
        order."""
        self.journal.append({"kind": "reorder"})

    def log_refusal(self, verdict: str, reason: str, nbytes: int) -> None:
        """A refused offer (rejected / radio-dropped / deduplicated
        duplicate): no payload to replay, but its ledger deltas and verdict
        must survive a crash (§2.8 counts refusals too)."""
        self.journal.append({"kind": "refusal", "verdict": verdict,
                             "reason": reason, "nbytes": int(nbytes)})

    def log_merge(self, codebook, version: int) -> None:
        self.journal.append({"kind": "merge", "version": int(version),
                             "codebook": encode_array(codebook)})

    def log_migration(self, phase: str, *, src: Optional[int] = None,
                      dst: Optional[int] = None,
                      policy: Optional[str] = None) -> None:
        self.journal.append({"kind": "migration", "phase": phase,
                             "src": src, "dst": dst, "policy": policy})

    # ----------------------------------------------------- journal readers

    def decode_offer_payload(self, entry: dict, *, device=None
                             ) -> CodePayload:
        """A journaled offer's carrier on ``device`` (cuda unless
        ``device="cpu"``)."""
        labels = entry.get("labels", {})

        def get(name):
            if name == "words":
                return decode_words(entry["words"])
            return decode_array(labels[name[len("label."):]])
        return _payload_from(entry["payload"], get, resolve_device(device))

    def decode_merge_codebook(self, entry: dict) -> np.ndarray:
        return decode_array(entry["codebook"])

    # ----------------------------------------------------------- snapshots

    def _snap_base(self, tick: int) -> str:
        return os.path.join(self.root, f"snap_{tick:08d}")

    def snapshot(self, service) -> str:
        """Write one complete snapshot of ``service``'s durable state. The
        manifest lands last (atomic rename): its presence is the commit
        point."""
        tick = int(service.tick_idx)
        base = self._snap_base(tick)
        arrays: Dict[str, np.ndarray] = {}

        store_man, store_arr = service.wire.store.snapshot_state()
        arrays.update({f"store.{k}": a for k, a in store_arr.items()})
        reg_man, reg_arr = service.wire.registry.snapshot_state()
        arrays.update({f"registry.{k}": a for k, a in reg_arr.items()})

        q = service.queue
        pending = []
        for i, pu in enumerate(q._pending):
            p = pu.packed
            arrays[f"q{i}.words"] = _host_words(p.payload)
            if pu.client_ids is not None:
                arrays[f"q{i}.client_ids"] = np.asarray(pu.client_ids)
            if p.labels:
                for t, y in p.labels.items():
                    arrays[f"q{i}.label.{t}"] = y.detach().cpu().numpy()
            pending.append({"arrival_round": int(pu.arrival_round),
                            "sent_round": int(pu.sent_round),
                            "has_client_ids": pu.client_ids is not None,
                            "payload": _payload_manifest(p)})

        manifest = {
            "tick": tick,
            "journal_pos": self.journal.position,
            "store": store_man,
            "registry": reg_man,
            "queue": {"bytes_sent": int(q.bytes_sent),
                      "bytes_delivered": int(q.bytes_delivered),
                      "bytes_dropped": int(q.bytes_dropped),
                      "bytes_rejected": int(q.bytes_rejected),
                      "bytes_duplicate": int(q.bytes_duplicate),
                      "pending": pending},
            "service": {"verdicts": dict(service.verdicts),
                        "verdict_bytes": dict(service.verdict_bytes),
                        "decoded_records": int(service.decoded_records),
                        "decode_dispatches": int(service.decode_dispatches),
                        "seen": [list(k) for k in service._seen]},
        }

        save_server_state(base + ".state.npz", service.wire.state)

        def write_npz(tmp):
            with open(tmp, "wb") as fh:
                np.savez(fh, **arrays)

        def write_json(tmp):
            with open(tmp, "w") as fh:
                json.dump(manifest, fh)

        _write_atomic(self.root, base + ".npz", ".npz", write_npz)
        _write_atomic(self.root, base + ".json", ".json", write_json)
        self._prune()
        return base + ".json"

    def _prune(self) -> None:
        for tick in self.snapshots[:-self.keep]:
            base = self._snap_base(tick)
            for suffix in (".json", ".npz", ".state.npz"):
                if os.path.exists(base + suffix):
                    os.remove(base + suffix)

    @property
    def snapshots(self) -> list:
        """Committed snapshot ticks, ascending (manifest + both array
        files present)."""
        out = []
        for f in sorted(os.listdir(self.root)):
            if f.startswith("snap_") and f.endswith(".json"):
                tick = int(f[len("snap_"):-len(".json")])
                base = self._snap_base(tick)
                if os.path.exists(base + ".npz") and \
                        os.path.exists(base + ".state.npz"):
                    out.append(tick)
        return out

    def load_snapshot(self, cfg, state_like=None, *, shard_fn=None,
                      device=None) -> dict:
        """Load the latest committed snapshot -> the recovery dict
        ``ContinuousIngestService.recover`` consumes, every tensor on
        ``device`` (cuda unless ``device="cpu"``). ``state_like`` is the
        reference's template argument; the port takes the server state's
        structure from ``cfg``."""
        from .registry import CodebookRegistry
        from .runtime import PendingUplink, UplinkQueue
        from .store import CodeStore, ShardedCodeStore

        dev = resolve_device(device)
        ticks = self.snapshots
        if not ticks:
            raise FileNotFoundError(
                f"no committed snapshot under {self.root!r}: the crashed "
                f"service was never constructed with persist")
        base = self._snap_base(ticks[-1])
        with open(base + ".json") as fh:
            manifest = json.load(fh)
        with np.load(base + ".npz") as data:
            arrays = {k: data[k] for k in data.files}

        state = load_server_state(base + ".state.npz", cfg, device=dev)

        store_man = manifest["store"]
        if store_man["kind"] == "sharded":
            store = ShardedCodeStore(cfg, shard_fn=shard_fn)
        else:
            store = CodeStore(cfg)
        store.load_state(store_man,
                         {k[len("store."):]: a for k, a in arrays.items()
                          if k.startswith("store.")}, device=dev)

        registry = CodebookRegistry(state.params["codebook"])
        registry.load_state(manifest["registry"],
                            {k[len("registry."):]: a
                             for k, a in arrays.items()
                             if k.startswith("registry.")}, device=dev)

        qman = manifest["queue"]
        queue = UplinkQueue()
        queue.bytes_sent = int(qman["bytes_sent"])
        queue.bytes_delivered = int(qman["bytes_delivered"])
        queue.bytes_dropped = int(qman["bytes_dropped"])
        queue.bytes_rejected = int(qman["bytes_rejected"])
        queue.bytes_duplicate = int(qman["bytes_duplicate"])
        for i, pm in enumerate(qman["pending"]):
            packed = _payload_from(
                pm["payload"], lambda name, i=i: arrays[f"q{i}.{name}"], dev)
            queue._pending.append(PendingUplink(
                arrival_round=int(pm["arrival_round"]), packed=packed,
                client_ids=(np.asarray(arrays[f"q{i}.client_ids"])
                            if pm["has_client_ids"] else None),
                sent_round=int(pm["sent_round"])))

        svc = manifest["service"]
        return {
            "snapshot_tick": int(manifest["tick"]),
            "journal_pos": int(manifest["journal_pos"]),
            "tick_idx": int(manifest["tick"]),
            "state": state, "store": store, "registry": registry,
            "queue": queue,
            "verdicts": {str(k): int(v)
                         for k, v in svc["verdicts"].items()},
            "verdict_bytes": {str(k): int(v)
                              for k, v in svc["verdict_bytes"].items()},
            "decoded_records": int(svc["decoded_records"]),
            "decode_dispatches": int(svc["decode_dispatches"]),
            "seen": OrderedDict(((int(c), int(s)), True)
                                for c, s in svc["seen"]),
        }
