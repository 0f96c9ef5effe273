"""Fault-injected uplink channel: the chaos plane between client and
server.

Port of ``repro.sim.faults``. :class:`FaultyChannel` sits between the
payload producer (``OctopusClient`` / ``CohortEngine.run_continuous``) and
``ContinuousIngestService.offer`` and applies a deterministic
:class:`FaultPlan`:

  * ``drop``      — the payload vanishes in the channel (bytes burn on the
                    §2.8 ledger, verdict ``rejected/radio_drop``);
  * ``duplicate`` — the payload arrives twice; the second copy carries the
                    SAME ``(client_id, seq)`` envelope, so the service's
                    dedup window answers ``duplicate``;
  * ``reorder``   — the two most recently queued payloads swap delivery
                    order (through the service's ``reorder_tail``, which
                    journals the swap: the reference's channel swaps the
                    queue directly, unjournaled, so its recovery can
                    rebuild the store in another order);
  * ``delay``     — extra channel latency in ``[1, max_delay]`` ticks;
  * ``corrupt``   — ONE word-level bit flip; the carrier's CRC32 no longer
                    matches -> ``rejected/corrupt`` at admission;
  * ``truncate``  — trailing word rows cut mid-flight; the stream is too
                    short for its declared shape -> ``corrupt``.

Every family draws from its OWN generator, seeded from
``fold_in(fold_in(key, send_index), purpose)`` with the scheduler's
threefry2x32 folding (``server/scheduler.py``), so the same key gives the
reference's fault decisions bit for bit, and toggling one knob perturbs no
other family's draws.

With a ``wire.session.RetryPolicy`` the channel also runs the client retry
loop: transient outcomes (``deferred``, ``queue_full``, ``radio_drop``,
``corrupt``) re-offer the ORIGINAL clean payload under the SAME envelope
after a capped exponential backoff.

The channel duck-types the service surface ``run_continuous`` uses
(``wire`` / ``offer`` / ``tick`` / ``drain`` / the merge and migration
delegates)::

    chan = FaultyChannel(service, FaultPlan(drop=0.1, corrupt=0.05), key=3)
    engine.run_continuous(chan, sched, data_fn, ...)
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.obs import recorder as _obs
from repro_torch.server.scheduler import _as_key, _fold_in, _rng_from_key
from repro_torch.wire.session import RetryPolicy

#: per-family generator purposes: fold_in(fold_in(key, send), PURPOSE)
_STREAM_DROP = 1
_STREAM_DUPLICATE = 2
_STREAM_REORDER = 3
_STREAM_DELAY = 4
_STREAM_CORRUPT = 5
_STREAM_TRUNCATE = 6

FAULT_KINDS = ("drop", "duplicate", "reorder", "delay", "corrupt",
               "truncate")


class FaultPlan(NamedTuple):
    """Per-uplink fault probabilities (all independent draws)."""
    drop: float = 0.0        # channel loss: bytes burn, payload vanishes
    duplicate: float = 0.0   # payload arrives twice (same envelope)
    reorder: float = 0.0     # swap delivery order with the previous uplink
    delay: float = 0.0       # extra channel latency ...
    max_delay: int = 3       # ... uniform in [1, max_delay] ticks
    corrupt: float = 0.0     # one word-level bit flip (CRC catches it)
    truncate: float = 0.0    # trailing word rows cut (short stream)

    @property
    def active(self) -> bool:
        return any(p > 0 for p in (self.drop, self.duplicate, self.reorder,
                                   self.delay, self.corrupt, self.truncate))


class FaultyChannel:
    """Deterministic chaos between the payload producer and the service.

    ``key`` is an int seed or two uint32 words (the reference's
    ``PRNGKey``'s data); the default is seed 0. Fault counts land in
    ``.faults`` (and stream out as ``fault`` trace events and
    ``fault_<kind>`` metrics), retransmits in ``.retries``.
    """

    def __init__(self, service, plan: FaultPlan = FaultPlan(), *,
                 key=None, retry: Optional[RetryPolicy] = None):
        self.service = service
        self.plan = plan
        self.key = _as_key(0 if key is None else key)
        self.retry = retry
        self.faults: Dict[str, int] = {}
        self.retries = 0
        self._sends = 0                         # per-send substream index
        self._next_seq: Dict[int, int] = {}     # auto-envelope counters
        self._retry_due: Dict[int, List[tuple]] = {}

    # ------------------------------------------------- service delegation

    @property
    def wire(self):
        return self.service.wire

    @property
    def queue(self):
        return self.service.queue

    @property
    def tick_idx(self) -> int:
        return self.service.tick_idx

    @property
    def verdicts(self) -> Dict[str, int]:
        return self.service.verdicts

    @property
    def verdict_bytes(self) -> Dict[str, int]:
        return self.service.verdict_bytes

    @property
    def decode_amortization(self) -> float:
        return self.service.decode_amortization

    def merge_stats(self, stats) -> int:
        return self.service.merge_stats(stats)

    def begin_migration(self, **kw):
        return self.service.begin_migration(**kw)

    def complete_migration(self):
        return self.service.complete_migration()

    # ------------------------------------------------------------- faults

    def _rng(self, purpose: int, idx: int) -> np.random.Generator:
        return _rng_from_key(_fold_in(_fold_in(self.key, idx), purpose))

    def _fault(self, kind: str, p, uplink_id) -> None:
        self.faults[kind] = self.faults.get(kind, 0) + 1
        rec = _obs.active()
        if rec is not None:
            rec.metrics.inc(f"fault_{kind}")
            rec.event("fault", fault=kind, tick=self.service.tick_idx,
                      nbytes=p.nbytes,
                      client_id=(None if uplink_id is None
                                 else int(uplink_id[0])))

    @staticmethod
    def _flip_bit(p, g: np.random.Generator):
        """One word-level bit flip on a host uint32 copy of the words,
        returned on the payload's device; the stale checksum convicts
        it."""
        words = p.payload.detach().cpu().numpy().view(np.uint32).copy()
        if words.size == 0:
            return p
        flat = words.reshape(-1)
        i = int(g.integers(0, flat.size))
        flat[i] ^= np.uint32(1) << np.uint32(int(g.integers(0, 32)))
        return p._replace(payload=torch.from_numpy(words.view(np.int32))
                          .to(p.payload.device))

    @staticmethod
    def _truncate(p, g: np.random.Generator):
        """Cut trailing word rows (None if the stream is too short to cut):
        the declared shape now needs more rows than arrived."""
        rows = int(p.payload.shape[0])
        if rows < 2:
            return None
        cut = int(g.integers(1, rows))
        return p._replace(payload=p.payload[:rows - cut].clone())

    # -------------------------------------------------------------- offer

    def offer(self, payload, *, client_ids=None, delay: int = 0,
              dropped: bool = False, uplink_id=None, _attempt: int = 0):
        """One uplink through the faulty channel -> admission verdict."""
        p = self.service.wire._coerce(payload)
        if uplink_id is None and client_ids is not None:
            ids = np.asarray(client_ids).reshape(-1)
            if ids.size:
                cid = int(ids[0])
                seq = self._next_seq.get(cid, 0)
                self._next_seq[cid] = seq + 1
                uplink_id = (cid, seq)
        if dropped:        # scheduler-level radio drop: not channel chaos
            return self.service.offer(p, client_ids=client_ids,
                                      delay=delay, dropped=True,
                                      uplink_id=uplink_id)
        plan, idx = self.plan, self._sends
        self._sends += 1

        if plan.drop and \
                self._rng(_STREAM_DROP, idx).random() < plan.drop:
            self._fault("drop", p, uplink_id)
            res = self.service.offer(p, client_ids=client_ids, delay=delay,
                                     dropped=True, uplink_id=uplink_id)
            self._maybe_retry(p, client_ids, uplink_id, res, _attempt)
            return res

        send = p
        g = self._rng(_STREAM_CORRUPT, idx)
        if plan.corrupt and g.random() < plan.corrupt:
            send = self._flip_bit(send, g)
            self._fault("corrupt", p, uplink_id)
        g = self._rng(_STREAM_TRUNCATE, idx)
        if plan.truncate and g.random() < plan.truncate:
            cut = self._truncate(send, g)
            if cut is not None:
                send = cut
                self._fault("truncate", p, uplink_id)
        extra = 0
        g = self._rng(_STREAM_DELAY, idx)
        if plan.delay and g.random() < plan.delay:
            extra = int(g.integers(1, plan.max_delay + 1))
            self._fault("delay", p, uplink_id)

        res = self.service.offer(send, client_ids=client_ids,
                                 delay=delay + extra, uplink_id=uplink_id)

        g = self._rng(_STREAM_REORDER, idx)
        if plan.reorder and res.ok and res.verdict != "duplicate" \
                and g.random() < plan.reorder:
            if self.service.reorder_tail():
                self._fault("reorder", p, uplink_id)
        g = self._rng(_STREAM_DUPLICATE, idx)
        if plan.duplicate and g.random() < plan.duplicate:
            self._fault("duplicate", p, uplink_id)
            self.service.offer(send, client_ids=client_ids,
                               delay=delay + extra, uplink_id=uplink_id)

        self._maybe_retry(p, client_ids, uplink_id, res, _attempt)
        return res

    # -------------------------------------------------------------- retry

    def _maybe_retry(self, p, client_ids, uplink_id, res,
                     attempt: int) -> None:
        """Schedule a clean retransmit of the SAME envelope on transient
        outcomes: the exactly-once dedup window makes a retry that raced a
        success harmless (``duplicate``)."""
        if self.retry is None or uplink_id is None:
            return
        if not self.retry.retryable(res) \
                or attempt >= self.retry.max_attempts:
            return
        wait = max(1, self.retry.backoff(
            attempt, salt=f"{uplink_id[0]}.{uplink_id[1]}"))
        due = self.service.tick_idx + wait
        self._retry_due.setdefault(due, []).append(
            (p, client_ids, uplink_id, attempt + 1))
        self.retries += 1
        rec = _obs.active()
        if rec is not None:
            rec.metrics.inc("retries")
            rec.event("retry", client_id=int(uplink_id[0]),
                      seq=int(uplink_id[1]), attempt=attempt,
                      wait_ticks=wait, verdict=res.verdict,
                      reason=res.reason)

    def _flush_retries(self) -> None:
        now = self.service.tick_idx
        for due in sorted(d for d in self._retry_due if d <= now):
            for (p, cids, uid, attempt) in self._retry_due.pop(due):
                self.offer(p, client_ids=cids, uplink_id=uid,
                           _attempt=attempt)

    # -------------------------------------------------------------- clock

    def tick(self, **kw):
        """Re-offer due retransmits, then advance the service clock."""
        self._flush_retries()
        return self.service.tick(**kw)

    def drain(self, max_ticks: int = 1000) -> list:
        """Tick until queue and retries are dry, then let the service drain
        its own background-decode tail."""
        out = []
        while (self._retry_due or len(self.service.queue)) \
                and len(out) < max_ticks:
            out.append(self.tick())
        if len(out) < max_ticks:
            out.extend(self.service.drain(max_ticks - len(out)))
        return out
