"""Cohort-streamed population rounds (OCTOPUS §2.2 at 100k+ clients).

Port of ``repro.sim.cohort``'s plans and streamed round. Stacking a whole
population's states, latents and uplinks in one round is the
materialization the cross-device regime forbids, so the round streams:

  * :class:`CohortPlan` partitions the participating slot ids into cohorts.
    Each cohort flows through the same :class:`~repro_torch.sim.engine.
    SimEngine` round (per-client encoder passes and ONE fused
    quantize-pack-stats dispatch), so peak memory is one cohort's state.
  * Per-cohort Step 5 contributions fold into an exactly associative
    accumulator (:class:`~repro_torch.core.ema.MergeStats`, int64 fixed
    point): any grouping or order of the same clients gives the
    bit-identical merged dictionary (``octopus.server_merge_stats``).
  * Per-cohort payloads ingest unchanged. Every client record is padded to
    whole super-groups on its own, so Σ cohort ``nbytes`` equals the
    whole-population round's bytes, and ``concat_payloads`` of the cohort
    payloads is the population payload word for word.

Clients deploy fresh from the server each round. A client's round is the
same bits in any cohort, singletons included (the engine's per-client
encoder passes, the encode kernel's per-record statistics and the
per-client EMA), so the merged statistics are grouping-invariant on the
card as on the CPU.

:meth:`CohortEngine.run_traffic` drives rounds from a ``RoundScheduler``
into an ``OctopusServer`` over a shared ``UplinkQueue`` (cohorts carved
WITHIN each (delay, dropped) delivery group, so every payload has one
fate); :meth:`CohortEngine.run_continuous` offers open-ended arrivals to a
``ContinuousIngestService`` a cohort payload at a time, so admission
decides which cohorts reach the Step 5 merge. Both run ONE fused
``encode_codes`` a cohort.

Typical use::

    eng = CohortEngine(cfg, gamma=0.99, n_local_steps=0)
    plan = CohortPlan.build(np.arange(100_000), cohort_size=1024)
    out = eng.round(server, plan, data_fn)     # streams 98 cohorts
    server = OC.server_merge_stats(server, out.stats)
"""
from __future__ import annotations

import time
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.core import octopus as OC
from repro_torch.core.dvqae import DVQAEConfig
from repro_torch.core.ema import (MergeStats, merge_stats, merge_stats_add,
                                  merge_stats_zero)
from repro_torch.obs import recorder as _obs
from repro_torch.wire.payload import CodePayload

from .engine import SimEngine

DataFn = Callable[[np.ndarray], object]     # slot ids -> (len(ids), B, ...)


class CohortPlan(NamedTuple):
    """A partition of participating slot ids into cohorts."""
    cohorts: Tuple[np.ndarray, ...]

    @classmethod
    def build(cls, members, cohort_size: int) -> "CohortPlan":
        """Chop ``members`` (slot ids, kept in order) into consecutive
        cohorts of ``cohort_size`` (the tail cohort may be smaller). A
        size-1 tail is folded into the previous cohort, as the reference
        does (its vmapped round compiles a single client differently); the
        port's round does not need it, and keeps the reference's plans."""
        m = np.asarray(members, dtype=int).reshape(-1)
        if m.size == 0:
            raise ValueError("CohortPlan needs at least one member")
        cs = int(cohort_size)
        if cs < 1:
            raise ValueError(f"cohort_size must be >= 1, got {cs}")
        cohorts = [m[i:i + cs] for i in range(0, m.size, cs)]
        if cs > 1 and len(cohorts) > 1 and cohorts[-1].size == 1:
            tail = cohorts.pop()
            cohorts[-1] = np.concatenate([cohorts[-1], tail])
        return cls(cohorts=tuple(cohorts))

    @classmethod
    def from_groups(cls, groups) -> "CohortPlan":
        """Arbitrary (possibly ragged) explicit grouping."""
        cohorts = tuple(np.asarray(g, dtype=int).reshape(-1)
                        for g in groups)
        if not cohorts or any(c.size == 0 for c in cohorts):
            raise ValueError("every cohort needs at least one member")
        return cls(cohorts=cohorts)

    @property
    def n_cohorts(self) -> int:
        return len(self.cohorts)

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(int(c.size) for c in self.cohorts)

    @property
    def members(self) -> np.ndarray:
        return np.concatenate(self.cohorts)

    @property
    def n_clients(self) -> int:
        return int(sum(self.sizes))


class CohortRound(NamedTuple):
    """One streamed population round."""
    payloads: Tuple[CodePayload, ...]   # one per cohort, ingest-ready
    stats: MergeStats                   # associative Step-5 accumulator
    n_clients: int
    nbytes: int                         # Σ measured cohort uplink bytes


class TrafficRound(NamedTuple):
    """Per-round ledger of a scheduler-driven traffic run."""
    round: int
    n_participants: int
    n_cohorts: int
    bytes_sent: int
    bytes_delivered: int
    merged_version: Optional[int]


class ContinuousTick(NamedTuple):
    """Per-tick ledger of an open-ended continuous-ingest run."""
    tick: int
    n_participants: int
    n_cohorts: int
    bytes_offered: int       # measured bytes at the door (incl. refusals)
    bytes_delivered: int     # landed in the store this tick
    n_rejected: int          # admission rejections this tick
    n_deferred: int          # admissions answered "back off"
    merged_version: Optional[int]


def _fate_groups(ev) -> dict:
    """Participants grouped by (straggler delay, dropped), slot order."""
    groups: dict = {}
    for j, slot in enumerate(ev.participants):
        key = (int(ev.delays[j]), bool(ev.dropped[j]))
        groups.setdefault(key, []).append(int(slot))
    return groups


class CohortEngine:
    """Streams population rounds cohort by cohort through ONE SimEngine."""

    def __init__(self, cfg: DVQAEConfig, *, lr: float = 1e-4,
                 gamma: float = 0.99, n_local_steps: int = 1, mesh=None):
        self.cfg = cfg
        self.engine = SimEngine(cfg, lr=lr, gamma=gamma,
                                n_local_steps=n_local_steps, mesh=mesh)
        self.bits = self.engine.bits

    def round(self, server: OC.ServerState, plan: CohortPlan,
              data_fn: DataFn, *, version: int = 0,
              labels_fn: Optional[DataFn] = None,
              round_idx: Optional[int] = None) -> CohortRound:
        """Steps 2-5 for ``plan``'s population, one cohort at a time.

        ``data_fn(slot_ids)`` returns the cohort's local batches
        ``(len(slot_ids), B, ...)``, keyed by slot id, so the same client
        sees the same data under any grouping. Clients deploy fresh from
        ``server``; payloads are stamped ``version``. ``round_idx`` only
        labels the flight recorder's per-cohort ``encode`` events.
        """
        cb = server.params["codebook"]
        K, M = cb.shape
        stats = merge_stats_zero(int(K), int(M), device=cb.device)
        payloads: List[CodePayload] = []
        for cohort in plan.cohorts:
            rec = _obs.active()
            t0 = time.perf_counter() if rec is not None else 0.0
            clients = self.engine.init_clients(server, int(cohort.size))
            labels = labels_fn(cohort) if labels_fn is not None else None
            clients, payload = self.engine.round(
                clients, data_fn(cohort), version=version, labels=labels)
            # per-client fixed-point quantization, then int64 adds: the
            # totals match the one-shot population merge for any grouping
            stats = merge_stats_add(stats, merge_stats(
                clients.params["codebook"], clients.ema.counts))
            payloads.append(payload)
            if rec is not None:
                _obs.settle(payload.payload, stats.num)
                fields = {"cohort_size": int(cohort.size)}
                if round_idx is not None:
                    fields["round"] = int(round_idx)
                rec.event("encode",
                          dur_ms=(time.perf_counter() - t0) * 1e3,
                          **fields, **_obs.payload_meta(payload))
        return CohortRound(payloads=tuple(payloads), stats=stats,
                           n_clients=plan.n_clients,
                           nbytes=sum(p.nbytes for p in payloads))

    # ------------------------------------------------------------ traffic

    def run_traffic(self, wire, scheduler, data_fn: DataFn, *,
                    cohort_size: int, n_rounds: int, merge_every: int = 0,
                    labels_fn: Optional[DataFn] = None,
                    queue=None) -> List[TrafficRound]:
        """Scheduler-driven rounds streaming into ``wire`` (an
        ``OctopusServer``): each round one ``scheduler.step()``,
        participants carved into cohorts within each (delay, dropped)
        group, payloads on the shared ``UplinkQueue``, due payloads
        ingested; every ``merge_every`` rounds the accumulated stats of
        the delivered-or-in-flight cohorts finish the Step 5 merge
        (``wire.merge_stats``) and later cohorts pack under the new
        version. Dropped cohorts lose their Step 5 contribution."""
        from repro_torch.server.runtime import UplinkQueue
        if queue is None:
            queue = UplinkQueue()
        acc: Optional[MergeStats] = None
        history: List[TrafficRound] = []
        for _ in range(n_rounds):
            rec = _obs.active()
            t0 = time.perf_counter() if rec is not None else 0.0
            ev = scheduler.step()
            sent = n_cohorts = 0
            for (delay, dropped), slots in sorted(_fate_groups(ev).items()):
                plan = CohortPlan.build(slots, cohort_size)
                out = self.round(wire.state, plan, data_fn,
                                 version=wire.version, labels_fn=labels_fn,
                                 round_idx=ev.round)
                for payload, cohort in zip(out.payloads, plan.cohorts):
                    sent += queue.send(payload, round=ev.round,
                                       delay=delay, dropped=dropped,
                                       client_ids=cohort)
                if not dropped:
                    acc = out.stats if acc is None else \
                        merge_stats_add(acc, out.stats)
                n_cohorts += plan.n_cohorts
            delivered, _ = queue.deliver(wire, ev.round)
            merged_version = None
            if merge_every and (ev.round + 1) % merge_every == 0 \
                    and acc is not None:
                merged_version = wire.merge_stats(acc)
                acc = None
            history.append(TrafficRound(
                round=ev.round, n_participants=int(ev.participants.size),
                n_cohorts=n_cohorts, bytes_sent=sent,
                bytes_delivered=delivered, merged_version=merged_version))
            if rec is not None:
                dur_ms = (time.perf_counter() - t0) * 1e3
                rec.event("round", round=ev.round,
                          n_participants=int(ev.participants.size),
                          n_cohorts=n_cohorts, bytes_sent=sent,
                          bytes_delivered=delivered,
                          queue_depth=len(queue),
                          merged_version=merged_version, dur_ms=dur_ms)
                rec.metrics.observe("round_ms", dur_ms)
                rec.metrics.set_gauge("uplink_queue_depth", len(queue))
        return history

    def run_continuous(self, service, scheduler, data_fn: DataFn, *,
                       cohort_size: int, n_ticks: int, merge_every: int = 0,
                       labels_fn: Optional[DataFn] = None,
                       migration_policy: Optional[str] = None
                       ) -> List[ContinuousTick]:
        """Open-ended traffic into a ``ContinuousIngestService``: each tick
        the scheduler draws the arrivals (``SchedulerConfig.rate`` for
        Poisson arrivals), they are carved into cohorts per (delay,
        dropped) fate and OFFERED one cohort payload at a time, and the
        service clock ticks once. Only admitted cohorts reach the Step 5
        merge. Every ``merge_every`` ticks the stats finish the merge; with
        ``migration_policy`` each merge also completes any open migration
        window and opens a fresh ``latest-1 -> latest`` one."""
        wire = service.wire
        acc: Optional[MergeStats] = None
        history: List[ContinuousTick] = []
        for _ in range(n_ticks):
            ev = scheduler.step()
            offered = n_cohorts = n_rej = n_def = 0
            for (delay, dropped), slots in sorted(_fate_groups(ev).items()):
                plan = CohortPlan.build(slots, cohort_size)
                for cohort in plan.cohorts:
                    out = self.round(wire.state,
                                     CohortPlan.from_groups([cohort]),
                                     data_fn, version=wire.version,
                                     labels_fn=labels_fn,
                                     round_idx=ev.round)
                    res = service.offer(out.payloads[0], client_ids=cohort,
                                        delay=delay, dropped=dropped)
                    offered += res.nbytes
                    if res.verdict == "rejected":
                        n_rej += 1
                    elif res.verdict != "duplicate":
                        if res.verdict == "deferred":
                            n_def += 1
                        acc = out.stats if acc is None else \
                            merge_stats_add(acc, out.stats)
                n_cohorts += plan.n_cohorts
            merged_version = None
            if merge_every and (ev.round + 1) % merge_every == 0 \
                    and acc is not None:
                merged_version = service.merge_stats(acc)
                acc = None
                if migration_policy is not None:
                    if wire.registry.migration is not None:
                        service.complete_migration()
                    service.begin_migration(policy=migration_policy)
            ts = service.tick(
                merged_version=merged_version,
                extra_fields={"n_participants": int(ev.participants.size),
                              "n_cohorts": n_cohorts})
            history.append(ContinuousTick(
                tick=ts.tick, n_participants=int(ev.participants.size),
                n_cohorts=n_cohorts, bytes_offered=offered,
                bytes_delivered=ts.bytes_delivered, n_rejected=n_rej,
                n_deferred=n_def, merged_version=merged_version))
        return history
