"""Continuous-ingest code-server runtime (port of ``repro.server``).

  store      — CodeStore: one capacity-bounded, versioned, lazily decoded
               ring buffer of packed transmissions; ShardedCodeStore:
               independent ring buffers per (codebook version, client
               shard) partition
  registry   — CodebookRegistry: immutable per-merge dictionary snapshots,
               the staleness-weighted Step 5 merge and rolling
               MigrationWindows (keep / retire / reencode)
  scheduler  — RoundScheduler: partial participation, stragglers, drops,
               churn and Poisson arrivals, the reference's event stream
               bit for bit from the same key
  multitask  — MultiTaskTrainer: N downstream heads from ONE bulk decode
  runtime    — ContinuousIngestService: clocked, admission-controlled
               ingest with background bulk decode, crash-consistent with
               ``persist=`` and ``recover``; AsyncCodeServer, the
               round-quantized shim over it
  persist    — ServerPersistence: the append-only journal and periodic
               snapshots of one service directory, in the reference's
               layout
"""
from repro_torch.wire.payload import CodePayload
from repro_torch.wire.session import AdmissionResult, OctopusServer

from .multitask import MultiTaskTrainer, TaskSpec
from .persist import ServerPersistence
from .registry import (MIGRATION_POLICIES, CodebookRegistry,
                       MigrationWindow)
from .runtime import (AsyncCodeServer, BulkDecodePolicy,
                      ContinuousIngestService, RoundStats, TickStats,
                      UplinkQueue)
from .scheduler import (STANDARD_SCENARIOS, DiurnalProfile, RoundEvent,
                        RoundScheduler, Scenario, SchedulerConfig)
from .store import CodeStore, ShardedCodeStore, StoreRecord

__all__ = ["AdmissionResult", "AsyncCodeServer", "BulkDecodePolicy",
           "CodePayload", "CodeStore", "CodebookRegistry",
           "ContinuousIngestService", "DiurnalProfile",
           "MIGRATION_POLICIES", "MigrationWindow", "MultiTaskTrainer",
           "OctopusServer", "RoundEvent", "RoundScheduler", "RoundStats",
           "STANDARD_SCENARIOS", "Scenario", "SchedulerConfig",
           "ServerPersistence", "ShardedCodeStore", "StoreRecord",
           "TaskSpec", "TickStats", "UplinkQueue"]
