"""Asynchronous code-server runtime (Step 6 as a subsystem).

Port of ``repro.server.runtime``. Two drivers share ONE wire endpoint
(:class:`~repro_torch.wire.session.OctopusServer`) and one byte ledger
(:class:`UplinkQueue`):

  * :class:`ContinuousIngestService` — clients ``offer`` uplinks whenever
    they like and admission control answers at once (accepted, migrated,
    deferred, rejected, duplicate); a clock ``tick`` delivers the due
    slice of the queue into the store and runs the background bulk
    decoder (``decode_codes``, one fused dispatch per (version, bits)
    group) under a :class:`BulkDecodePolicy`.
  * :class:`AsyncCodeServer` — the round-quantized shim over it: a fixed
    slot array of clients, a ``RoundScheduler`` deciding who participates,
    straggles and churns, ``SimEngine.round_indices`` for the
    participants, one ``CodePayload.pack`` (``pack_codes``) per (version,
    delay, dropped) delivery group, one service tick per round, and every
    ``merge_every`` rounds the staleness-weighted Step 5 merge over the
    ACTIVE population (``decay ** lag`` formed on the host, the merge
    unfused: ``core/octopus.py::server_merge_codebooks``).

With ``persist=`` (a ``server.persist.ServerPersistence``) the service is
crash-consistent: every admitted offer, refusal, tick, merge and migration
op is journaled before it mutates state, with periodic snapshots, and
:meth:`ContinuousIngestService.recover` rebuilds a killed service from the
latest snapshot and the journal tail replayed through the normal paths.
The directory layout is the reference's, so either package recovers the
other's.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import octopus as OC
from repro_torch.obs import recorder as _obs
from repro_torch.sim.engine import (SimEngine, replicate_clients,
                                    scatter_clients, select_clients)
from repro_torch.wire.payload import CodePayload
from repro_torch.wire.session import AdmissionResult, OctopusServer

from .registry import CodebookRegistry
from .scheduler import RoundEvent, RoundScheduler

class PendingUplink(NamedTuple):
    """A wire payload still in flight (straggler delay); its codebook
    version and label channels ride INSIDE the payload."""
    arrival_round: int
    packed: CodePayload
    client_ids: np.ndarray
    sent_round: int


def _n_clients(client_ids) -> Optional[int]:
    return None if client_ids is None else len(client_ids)


class UplinkQueue:
    """In-flight uplink payloads + the measured byte ledger (§2.8):
    ``sent == delivered + dropped + rejected + duplicate + in_flight``.

    ``send`` charges every payload's MEASURED ``nbytes`` (dropped packets
    burn bytes but never land); ``deliver`` pushes everything whose
    arrival round has come through the wire endpoint.
    """

    def __init__(self):
        self._pending: List[PendingUplink] = []
        self.bytes_sent = 0
        self.bytes_delivered = 0
        self.bytes_dropped = 0
        self.bytes_rejected = 0
        self.bytes_duplicate = 0

    def send(self, packed: CodePayload, *, round: int, delay: int = 0,
             dropped: bool = False, client_ids=None) -> int:
        """Queue one payload; returns its measured nbytes."""
        n = packed.nbytes
        self.bytes_sent += n
        rec = _obs.active()
        if rec is not None:
            rec.uplink(packed, round=int(round), delay=int(delay),
                       dropped=bool(dropped),
                       n_clients=_n_clients(client_ids))
        if dropped:
            self.bytes_dropped += n
            return n
        self._pending.append(PendingUplink(
            arrival_round=int(round) + int(delay), packed=packed,
            client_ids=client_ids, sent_round=int(round)))
        if rec is not None:
            rec.metrics.set_gauge("uplink_queue_depth", len(self._pending))
        return n

    def charge(self, packed: CodePayload, *, round: int, reason: str = "",
               client_ids=None) -> int:
        """Ledger a REFUSED payload that never queues (refusals still
        burned their uplink bytes). Returns its measured nbytes."""
        n = packed.nbytes
        self.bytes_sent += n
        self.bytes_rejected += n
        rec = _obs.active()
        if rec is not None:
            rec.uplink(packed, round=int(round), rejected=True,
                       reason=reason, n_clients=_n_clients(client_ids))
        return n

    def charge_duplicate(self, packed: CodePayload, *, round: int,
                         client_ids=None) -> int:
        """Ledger a retransmit of an envelope the server already holds: the
        bytes crossed the uplink again (sent) but never count delivered."""
        n = packed.nbytes
        self.bytes_sent += n
        self.bytes_duplicate += n
        rec = _obs.active()
        if rec is not None:
            rec.uplink(packed, round=int(round), duplicate=True,
                       n_clients=_n_clients(client_ids))
        return n

    def reorder_tail(self) -> bool:
        """Swap the two most recently queued payloads (fault injection: the
        channel delivered them out of send order). Returns whether a swap
        happened: with fewer than two in flight there is nothing to
        reorder."""
        if len(self._pending) < 2:
            return False
        self._pending[-1], self._pending[-2] = \
            self._pending[-2], self._pending[-1]
        return True

    def deliver(self, wire: OctopusServer, round: int, *,
                results: Optional[list] = None) -> tuple:
        """Ingest every due payload; returns (nbytes, n_payloads).
        ``results`` collects one :class:`AdmissionResult` per delivery; a
        payload the endpoint REJECTS now (its version was retired while it
        was in flight) moves its bytes to ``bytes_rejected``."""
        delivered, n_del = 0, 0
        still: List[PendingUplink] = []
        for p in self._pending:
            if p.arrival_round <= round:
                res = wire.ingest(p.packed, client_ids=p.client_ids,
                                  round=p.sent_round)
                if results is not None:
                    results.append(res)
                if res.ok:
                    delivered += p.packed.nbytes
                    n_del += 1
                else:
                    self.bytes_rejected += p.packed.nbytes
                    late = _obs.active()
                    if late is not None:
                        late.metrics.inc("admission_rejected")
                        late.event("admission", round=int(round),
                                   verdict="rejected", reason=res.reason,
                                   queue_depth=len(self._pending),
                                   nbytes=p.packed.nbytes)
            else:
                still.append(p)
        self._pending = still
        self.bytes_delivered += delivered
        rec = _obs.active()
        if rec is not None:
            rec.metrics.set_gauge("uplink_queue_depth", len(self._pending))
        return delivered, n_del

    @property
    def bytes_in_flight(self) -> int:
        return sum(p.packed.nbytes for p in self._pending)

    def __len__(self) -> int:
        return len(self._pending)


class RoundStats(NamedTuple):
    round: int
    n_participants: int
    n_joined: int
    n_left: int
    bytes_sent: int          # measured, incl. packets that will drop
    bytes_delivered: int     # measured, landed in the store this round
    n_delivered: int         # delivery groups landed this round
    merged_version: Optional[int]   # registry version if this round merged


class BulkDecodePolicy(NamedTuple):
    """When the background bulk decoder fires and how much it batches:
    every ``interval_ticks`` service ticks, if at least ``min_batch``
    freshly stored records wait, decode up to ``max_batch`` of them in as
    few fused dispatches as their (version, bits) grouping allows.
    ``interval_ticks=0`` disables it (decode only when a trainer asks)."""
    min_batch: int = 1
    max_batch: int = 64
    interval_ticks: int = 1


class TickStats(NamedTuple):
    """What one ``ContinuousIngestService.tick`` did."""
    tick: int
    n_offered: int           # uplinks offered since the previous tick
    bytes_offered: int       # their measured bytes (incl. refusals)
    n_delivered: int         # payloads ingested into the store this tick
    bytes_delivered: int
    n_decoded: int           # records background-bulk-decoded this tick
    decode_dispatches: int   # fused dispatches those decodes cost
    queue_depth: int         # in-flight payloads after this tick
    bytes_in_flight: int
    merged_version: Optional[int] = None


class ContinuousIngestService:
    """Clocked, admission-controlled ingest over ONE wire endpoint.

    Admission happens AT OFFER TIME:
      * wire violations (§2.5 flag, wire revision, retired or unknown
        version, integrity) are rejected at the door; the bytes still burn
        on the ledger and the payload never queues;
      * a full queue (``capacity``) rejects with ``queue_full``;
      * a queue past ``defer_depth`` admits but answers ``deferred``;
      * payloads packed under the src version of an open migration window
        admit as ``migrated``;
      * an ``uplink_id`` of ``(client_id, seq)`` names the envelope: a
        retransmit of a key already ADMITTED answers ``duplicate`` and is
        never stored twice (a window of ``dedup_window`` keys).
    Every offer gets an :class:`AdmissionResult`; per-verdict counts and
    bytes live on ``.verdicts`` / ``.verdict_bytes``.

    With ``persist`` (a ``ServerPersistence``) the service is
    crash-consistent: snapshot 0 at construction, every state-mutating op
    journaled, a snapshot every ``persist.snapshot_every`` ticks.
    :meth:`recover` = latest snapshot + journal replay; the recovered store
    decodes bit-identically to the uninterrupted run's, even when the kill
    landed mid-migration.
    """

    def __init__(self, wire: OctopusServer, *,
                 queue: Optional[UplinkQueue] = None,
                 capacity: Optional[int] = None,
                 defer_depth: Optional[int] = None,
                 decode_policy: BulkDecodePolicy = BulkDecodePolicy(),
                 dedup_window: int = 4096, persist=None):
        from .persist import ServerPersistence
        if persist is not None and not isinstance(persist,
                                                  ServerPersistence):
            raise TypeError(f"persist must be a ServerPersistence, got "
                            f"{type(persist).__name__}")
        self.wire = wire
        self.queue = queue if queue is not None else UplinkQueue()
        self.capacity = capacity
        if defer_depth is None and capacity is not None:
            defer_depth = max(1, (3 * capacity) // 4)
        self.defer_depth = defer_depth
        self.decode_policy = decode_policy
        self.dedup_window = int(dedup_window)
        self.tick_idx = 0
        self.verdicts: Dict[str, int] = {}
        self.verdict_bytes: Dict[str, int] = {}
        self.decoded_records = 0
        self.decode_dispatches = 0
        self._pending_decode: list = []
        self._tick_offered = 0
        self._tick_bytes = 0
        self._seen: "OrderedDict" = OrderedDict()   # admitted uplink_ids
        self._replaying = False
        self._persist = persist
        self.recovery: Optional[dict] = None   # what recover() replayed
        if persist is not None:
            # snapshot 0: recovery always has a floor to replay from
            persist.snapshot(self)

    @property
    def _journaling(self) -> bool:
        return self._persist is not None and not self._replaying

    # ------------------------------------------------------------- offers

    def _refuse(self, verdict: str, reason: str, nbytes: int) -> None:
        """Journal a refusal, so that the recovered ledger and verdict
        histogram match the uninterrupted run's (the payload never lands,
        so only its deltas are journaled)."""
        if self._journaling:
            self._persist.log_refusal(verdict, reason, nbytes)

    def _replay_refusal(self, verdict: str, reason: str,
                        nbytes: int) -> None:
        """Re-apply a journaled refusal's ledger and histogram deltas."""
        q = self.queue
        q.bytes_sent += nbytes
        if verdict == "duplicate":
            q.bytes_duplicate += nbytes
        elif reason == "radio_drop":
            q.bytes_dropped += nbytes
        else:
            q.bytes_rejected += nbytes
        self.verdicts[verdict] = self.verdicts.get(verdict, 0) + 1
        self.verdict_bytes[verdict] = \
            self.verdict_bytes.get(verdict, 0) + nbytes

    def _result(self, verdict: str, reason: str, nbytes: int
                ) -> AdmissionResult:
        self._tick_offered += 1
        self._tick_bytes += nbytes
        self.verdicts[verdict] = self.verdicts.get(verdict, 0) + 1
        self.verdict_bytes[verdict] = \
            self.verdict_bytes.get(verdict, 0) + nbytes
        rec = _obs.active()
        if rec is not None:
            rec.metrics.inc(f"admission_{verdict}")
            rec.event("admission", round=self.tick_idx, verdict=verdict,
                      reason=reason, queue_depth=len(self.queue),
                      nbytes=nbytes)
        return AdmissionResult(verdict, reason, nbytes, None)

    def offer(self, payload, *, client_ids=None, delay: int = 0,
              dropped: bool = False, uplink_id=None) -> AdmissionResult:
        """One uplink at the door -> admission verdict. ``dropped`` models
        a radio loss: the bytes burn, the payload never lands (verdict
        ``rejected/radio_drop``). Admitted payloads queue and land at the
        ``tick`` whose clock reaches their ``delay``."""
        p = self.wire._coerce(payload)
        if dropped:
            self.queue.send(p, round=self.tick_idx, delay=int(delay),
                            dropped=True, client_ids=client_ids)
            self._refuse("rejected", "radio_drop", p.nbytes)
            return self._result("rejected", "radio_drop", p.nbytes)
        key = None if uplink_id is None else \
            (int(uplink_id[0]), int(uplink_id[1]))
        if key is not None and key in self._seen:
            self.queue.charge_duplicate(p, round=self.tick_idx,
                                        client_ids=client_ids)
            self._refuse("duplicate", "dedup_window", p.nbytes)
            return self._result("duplicate", "dedup_window", p.nbytes)
        verdict, reason = self.wire.precheck(p)
        if verdict == "rejected":
            self.queue.charge(p, round=self.tick_idx, reason=reason,
                              client_ids=client_ids)
            self._refuse(verdict, reason, p.nbytes)
            return self._result(verdict, reason, p.nbytes)
        if self.capacity is not None and len(self.queue) >= self.capacity:
            self.queue.charge(p, round=self.tick_idx, reason="queue_full",
                              client_ids=client_ids)
            self._refuse("rejected", "queue_full", p.nbytes)
            return self._result("rejected", "queue_full", p.nbytes)
        if key is not None:
            self._seen[key] = True
            while len(self._seen) > self.dedup_window:
                self._seen.popitem(last=False)
        if self._journaling:
            self._persist.log_offer(p, client_ids=client_ids,
                                    delay=int(delay), uplink_id=key)
        self.queue.send(p, round=self.tick_idx, delay=int(delay),
                        client_ids=client_ids)
        if verdict == "accepted" and self.defer_depth is not None \
                and len(self.queue) > self.defer_depth:
            verdict, reason = "deferred", "queue_pressure"
        return self._result(verdict, reason, p.nbytes)

    # -------------------------------------------------------------- clock

    def tick(self, *, merged_version: Optional[int] = None,
             extra_fields: Optional[Dict] = None,
             emit_event: bool = True) -> TickStats:
        """Advance the clock one step: deliver every due payload into the
        store, then (under ``decode_policy``) bulk-decode a batch of
        freshly stored records."""
        rec = _obs.active()
        t0 = time.perf_counter() if rec is not None else 0.0
        if self._journaling:
            self._persist.log_tick()
        results: list = []
        delivered, n_del = self.queue.deliver(self.wire, self.tick_idx,
                                              results=results)
        for res in results:
            if res.ok and res.record is not None:
                self._pending_decode.append(res.record)

        n_decoded, n_disp = 0, 0
        pol = self.decode_policy
        if pol.interval_ticks and \
                (self.tick_idx + 1) % pol.interval_ticks == 0 and \
                len(self._pending_decode) >= pol.min_batch:
            batch = self._pending_decode[:pol.max_batch]
            self._pending_decode = self._pending_decode[pol.max_batch:]
            n_decoded, n_disp = self._bulk_decode(batch)

        stats = TickStats(
            tick=self.tick_idx, n_offered=self._tick_offered,
            bytes_offered=self._tick_bytes, n_delivered=n_del,
            bytes_delivered=delivered, n_decoded=n_decoded,
            decode_dispatches=n_disp, queue_depth=len(self.queue),
            bytes_in_flight=self.queue.bytes_in_flight,
            merged_version=merged_version)
        if rec is not None and emit_event:
            dur_ms = (time.perf_counter() - t0) * 1e3
            rec.event("round", round=self.tick_idx,
                      n_offered=self._tick_offered,
                      bytes_sent=self._tick_bytes,
                      bytes_delivered=delivered,
                      n_delivered=n_del, n_decoded=n_decoded,
                      queue_depth=len(self.queue),
                      bytes_in_flight=self.queue.bytes_in_flight,
                      merged_version=merged_version, dur_ms=dur_ms,
                      **(extra_fields or {}))
            rec.metrics.observe("tick_ms", dur_ms)
        self._tick_offered = 0
        self._tick_bytes = 0
        self.tick_idx += 1
        if self._journaling and self._persist.snapshot_every \
                and self.tick_idx % self._persist.snapshot_every == 0:
            self._persist.snapshot(self)
        return stats

    def _bulk_decode(self, records) -> tuple:
        """Background decode: ONE fused dispatch per (version, bits) group
        of the batch, each against its pinned registry snapshot."""
        from .store import decode_group
        by_key: Dict[tuple, list] = {}
        for r in records:
            by_key.setdefault((r.version, r.packed.bits), []).append(r)
        rec = _obs.active()
        n_decoded = 0
        for (v, _), recs in by_key.items():
            cb = self.wire.registry.get(v)
            t0 = time.perf_counter() if rec is not None else 0.0
            blocks = decode_group(recs, self.wire.cfg, self.wire.state, cb)
            if rec is not None:
                _obs.settle(*blocks)
                dur_ms = (time.perf_counter() - t0) * 1e3
                rec.event("decode", version=int(v), dur_ms=dur_ms,
                          n_records=len(recs),
                          n_samples=int(sum(b.shape[0] for b in blocks)))
                rec.metrics.observe(f"decode_ms/v{int(v)}", dur_ms)
            n_decoded += len(recs)
        self.decoded_records += n_decoded
        self.decode_dispatches += len(by_key)
        return n_decoded, len(by_key)

    def drain(self, max_ticks: int = 1000) -> List[TickStats]:
        """Tick until the queue is empty (or ``max_ticks``), then let the
        background decoder catch up; a tail batch the policy would never
        take on its own is flushed directly."""
        out = []
        while len(self.queue) and len(out) < max_ticks:
            out.append(self.tick())
        pol = self.decode_policy
        while self._pending_decode and len(out) < max_ticks:
            if not pol.interval_ticks \
                    or len(self._pending_decode) < pol.min_batch:
                batch = self._pending_decode[:pol.max_batch]
                self._pending_decode = self._pending_decode[pol.max_batch:]
                self._bulk_decode(batch)
            else:
                out.append(self.tick())
        return out

    def reorder_tail(self) -> bool:
        """Swap the two most recently queued payloads (the chaos plane's
        ``reorder``), journaled: replay must deliver them in the swapped
        order, or a kill before their delivery would rebuild the store in
        another order (and evict other records). Returns whether a swap
        happened."""
        swapped = self.queue.reorder_tail()
        if swapped and self._journaling:
            self._persist.log_reorder()
        return swapped

    # ------------------------------------------- journaled server-side ops

    def merge_stats(self, stats) -> int:
        """Step 5 merge through the service door
        (``OctopusServer.merge_stats``), journaled as the POST-merge
        dictionary and its version, so replay re-registers the
        bit-identical snapshot without the client statistics."""
        version = self.wire.merge_stats(stats)
        if self._journaling:
            self._persist.log_merge(self.wire.state.params["codebook"],
                                    version)
        return version

    def begin_migration(self, *, src: Optional[int] = None,
                        dst: Optional[int] = None, policy: str = "keep"):
        """Journaled ``OctopusServer.begin_migration``: a kill with the
        window open replays back INTO the open window."""
        win = self.wire.begin_migration(src=src, dst=dst, policy=policy)
        if self._journaling:
            self._persist.log_migration("begin", src=win.src, dst=win.dst,
                                        policy=win.policy)
        return win

    def complete_migration(self):
        """Journaled ``OctopusServer.complete_migration``."""
        progress = self.wire.complete_migration()
        if self._journaling:
            self._persist.log_migration("complete")
        return progress

    def _replay_merge(self, codebook, version: int) -> None:
        """Re-apply a journaled merge: adopt the journaled post-merge
        dictionary (``server_merge_stats`` replaces only the codebook) and
        re-register it as the journaled version."""
        params = self.wire.state.params
        cb = torch.as_tensor(np.asarray(codebook, np.float32),
                             device=params["codebook"].device)
        self.wire.state = self.wire.state._replace(
            params={**params, "codebook": cb})
        got = self.wire.registry.register(cb)
        if got != int(version):
            raise RuntimeError(
                f"journal replay diverged: merge registered v{got}, "
                f"journal says v{version}")

    # ------------------------------------------------------------ recovery

    def _replay(self, persist, entry: dict) -> None:
        """Apply one journal entry through the normal code paths."""
        kind = entry["kind"]
        if kind == "offer":
            self.offer(persist.decode_offer_payload(entry,
                                                    device=self.wire.device),
                       client_ids=entry.get("client_ids"),
                       delay=entry.get("delay", 0),
                       uplink_id=entry.get("uplink_id"))
        elif kind == "refusal":
            self._replay_refusal(entry["verdict"], entry["reason"],
                                 entry["nbytes"])
        elif kind == "reorder":
            if not self.queue.reorder_tail():
                raise RuntimeError("journal replay diverged: a reorder with "
                                   "fewer than two payloads in flight")
        elif kind == "tick":
            self.tick(emit_event=False)
        elif kind == "merge":
            self._replay_merge(persist.decode_merge_codebook(entry),
                               entry["version"])
        elif kind == "migration" and entry["phase"] == "begin":
            self.wire.begin_migration(src=entry["src"], dst=entry["dst"],
                                      policy=entry["policy"])
        elif kind == "migration" and entry["phase"] == "complete":
            self.wire.complete_migration()
        else:
            raise ValueError(f"journal entry of unknown kind {kind!r} "
                             f"(phase {entry.get('phase')!r}): refusing to "
                             f"recover past it")

    @classmethod
    def recover(cls, persist, cfg, state_like=None, *, shard_fn=None,
                device=None, **service_kw) -> "ContinuousIngestService":
        """Rebuild a crashed service: latest snapshot + journal replay.

        ``persist`` is a ``ServerPersistence`` rooted at the crashed
        service's directory (or the directory path itself), written by
        either package; ``cfg`` is the deployment's DVQAEConfig;
        ``state_like`` is the reference's template argument (the port
        takes the structure from ``cfg``). Everything lands on ``device``
        (cuda unless ``device="cpu"``). Journal entries after the
        snapshot's high-water mark replay through the NORMAL
        offer/tick/merge/migration paths with the flight recorder detached
        (the crashed run already emitted those events); one ``recovery``
        event summarizes the drill, and ``.recovery`` holds the same
        figures. ``service_kw`` (capacity, defer_depth, decode_policy, ...)
        must match the crashed service's construction.
        """
        from .persist import ServerPersistence
        if not isinstance(persist, ServerPersistence):
            persist = ServerPersistence(persist, resume=True)
        t0 = time.perf_counter()
        snap = persist.load_snapshot(cfg, state_like, shard_fn=shard_fn,
                                     device=device)
        wire = OctopusServer(snap["state"], cfg, store=snap["store"],
                             registry=snap["registry"], device=device)
        service = cls(wire, **service_kw)
        service.queue = snap["queue"]
        service.tick_idx = snap["tick_idx"]
        service.verdicts = snap["verdicts"]
        service.verdict_bytes = snap["verdict_bytes"]
        service.decoded_records = snap["decoded_records"]
        service.decode_dispatches = snap["decode_dispatches"]
        service._seen = snap["seen"]

        # replay the journal tail with the recorder DETACHED: these
        # mutations already streamed their events before the crash
        rec = _obs.active()
        if rec is not None:
            _obs.uninstall()
        service._replaying = True
        n_replayed = 0
        try:
            for entry in persist.journal.entries(start=snap["journal_pos"]):
                service._replay(persist, entry)
                n_replayed += 1
        finally:
            service._replaying = False
            if rec is not None:
                _obs.install(rec)
        service._persist = persist
        service.recovery = dict(
            tick=service.tick_idx, snapshot_tick=snap["snapshot_tick"],
            n_replayed=n_replayed,
            dur_ms=(time.perf_counter() - t0) * 1e3,
            queue_depth=len(service.queue),
            store_records=len(service.wire.store))
        rec = _obs.active()
        if rec is not None:
            rec.metrics.inc("recoveries")
            rec.event("recovery", **service.recovery)
        service.recovery["decode_dispatches_replayed"] = \
            service.decode_dispatches - snap["decode_dispatches"]
        return service

    # ----------------------------------------------------------- metrics

    @property
    def decode_amortization(self) -> float:
        """Records decoded per fused dispatch (higher = better batching)."""
        return self.decoded_records / max(self.decode_dispatches, 1)

    @property
    def n_rejected(self) -> int:
        return self.verdicts.get("rejected", 0)

    @property
    def n_deferred(self) -> int:
        return self.verdicts.get("deferred", 0)


class AsyncCodeServer:
    """Server runtime: scheduler-driven rounds over a versioned store.

    A thin round-quantized shim over :class:`ContinuousIngestService`: each
    ``run_round`` offers the round's delivery groups, merges on schedule
    and ticks the clock once. The background bulk decoder is off
    (``interval_ticks=0``): the round driver decodes when its trainer asks.
    ``device`` places the server state (cuda unless ``device="cpu"``).
    """

    def __init__(self, engine: SimEngine, server: OC.ServerState,
                 scheduler: RoundScheduler, *, store=None,
                 registry: Optional[CodebookRegistry] = None,
                 merge_every: int = 0, staleness_decay: float = 0.5,
                 redeploy_on_merge: bool = True, device=None):
        self.engine = engine
        self.scheduler = scheduler
        self.n_slots = scheduler.n_slots
        # ONE wire endpoint owns server state + registry + store
        self.wire = OctopusServer(server, engine.cfg, store=store,
                                  registry=registry, device=device)
        self.merge_every = merge_every
        self.staleness_decay = staleness_decay
        self.redeploy_on_merge = redeploy_on_merge

        self.clients = engine.init_clients(self.server, self.n_slots)
        self.slot_versions = np.full(self.n_slots, self.registry.latest,
                                     dtype=int)
        self._participated = np.zeros(self.n_slots, dtype=bool)
        self.service = ContinuousIngestService(
            self.wire, decode_policy=BulkDecodePolicy(interval_ticks=0))
        self.queue = self.service.queue
        self.n_merges = 0

    @property
    def round(self) -> int:
        return self.service.tick_idx

    # --------------------------------------------- wire endpoint delegates

    @property
    def server(self) -> OC.ServerState:
        return self.wire.state

    @property
    def registry(self) -> CodebookRegistry:
        return self.wire.registry

    @property
    def store(self):
        return self.wire.store

    @property
    def bytes_sent(self) -> int:
        return self.queue.bytes_sent

    @property
    def bytes_delivered(self) -> int:
        return self.queue.bytes_delivered

    @property
    def bytes_dropped(self) -> int:
        return self.queue.bytes_dropped

    # ------------------------------------------------------------ helpers

    def _deploy_fresh(self, ids: np.ndarray) -> None:
        """(Re-)deploy slots from the CURRENT server (Step 2 for joiners):
        the server's codebook, a fresh EMA, and fresh copies of its modules
        where clients own theirs."""
        if ids.size == 0:
            return
        shared = isinstance(self.clients.params["encoder"], torch.nn.Module)
        fresh = replicate_clients(self.server, int(ids.size),
                                  share_modules=shared)
        self.clients = scatter_clients(self.clients, ids, fresh)
        self.slot_versions[ids] = self.registry.latest

    # -------------------------------------------------------------- round

    def run_round(self, data, labels=None) -> RoundStats:
        """One scheduler-driven round. ``data``: (n_slots, B, ...), every
        slot's would-be local batch (only participants' rows are read);
        ``labels``: a per-task dict (or bare array) of (n_slots, B) labels
        riding with the uplink."""
        if data.shape[0] != self.n_slots:
            raise ValueError(f"data has {data.shape[0]} slot batches for "
                             f"{self.n_slots} slots")
        rec = _obs.active()
        t0 = time.perf_counter() if rec is not None else 0.0
        ev: RoundEvent = self.scheduler.step()
        self._deploy_fresh(ev.joined)

        ids = ev.participants
        idx = None
        if ids.size:
            x = data[torch.as_tensor(ids, device=data.device)] \
                if isinstance(data, torch.Tensor) else data[ids]
            sub, idx = self.engine.round_indices(
                select_clients(self.clients, ids), x)
            self.clients = scatter_clients(self.clients, ids, sub)
        self._participated[ids] = True

        label_dict = None
        if labels is not None:
            label_dict = labels if isinstance(labels, dict) \
                else {"label": labels}

        # delivery groups (version, delay, dropped): each group's payload
        # carries ITS version and label channels
        sent = 0
        versions = self.slot_versions[ids]
        groups: Dict[tuple, list] = {}
        for j in range(ids.size):
            k = (int(versions[j]), int(ev.delays[j]), bool(ev.dropped[j]))
            groups.setdefault(k, []).append(j)
        for (version, delay, dropped), pos in groups.items():
            pos = np.asarray(pos)
            gidx = idx[torch.as_tensor(pos, device=idx.device)]
            glabels = None
            if label_dict is not None:
                grows = torch.as_tensor(ids[pos], dtype=torch.long)
                glabels = {t: torch.as_tensor(y)[grows].reshape(-1)
                           for t, y in label_dict.items()}
            packed = CodePayload.pack(gidx, bits=self.engine.bits,
                                      version=version, labels=glabels)
            res = self.service.offer(packed, client_ids=ids[pos],
                                     delay=delay, dropped=dropped)
            sent += res.nbytes

        # the Step 5 merge, decided BEFORE the tick so the round carries it
        this_round = self.round
        merged_version = None
        if self.merge_every and (this_round + 1) % self.merge_every == 0:
            merged_version = self._merge()

        ts = self.service.tick(merged_version=merged_version,
                               emit_event=False)
        stats = RoundStats(round=this_round, n_participants=int(ids.size),
                           n_joined=int(ev.joined.size),
                           n_left=int(ev.left.size), bytes_sent=sent,
                           bytes_delivered=ts.bytes_delivered,
                           n_delivered=ts.n_delivered,
                           merged_version=merged_version)
        if rec is not None:
            dur_ms = (time.perf_counter() - t0) * 1e3
            rec.event("round", round=this_round,
                      n_participants=int(ids.size),
                      n_joined=int(ev.joined.size),
                      n_left=int(ev.left.size), bytes_sent=sent,
                      bytes_delivered=ts.bytes_delivered,
                      queue_depth=len(self.queue),
                      bytes_in_flight=self.queue.bytes_in_flight,
                      merged_version=merged_version, dur_ms=dur_ms)
            rec.metrics.observe("round_ms", dur_ms)
        return stats

    def _merge(self) -> int:
        act = np.nonzero(self.scheduler.active)[0]
        rows = torch.as_tensor(act, dtype=torch.long,
                               device=self.clients.params["codebook"].device)
        version = self.wire.merge(
            self.clients.params["codebook"][rows],
            self.clients.ema.counts[rows],
            client_versions=self.slot_versions[act],
            staleness_decay=self.staleness_decay)
        self.n_merges += 1
        if self.redeploy_on_merge:
            # only slots that participated since the last merge synced;
            # the rest keep their stale deployment and version
            self._deploy_fresh(np.nonzero(self._participated
                                          & self.scheduler.active)[0])
        self._participated[:] = False
        return version

    # ---------------------------------------------------------- downstream

    def dataset(self, version=None):
        """Version-correct bulk decode of everything delivered so far
        (``OctopusServer.features``)."""
        return self.wire.features(version=version)

    @property
    def in_flight(self) -> int:
        return len(self.queue)
