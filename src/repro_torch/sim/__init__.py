"""Batched multi-client OCTOPUS simulation (port of ``repro.sim``).

  engine  — stacked client populations, per-client encoder passes and ONE
            fused encode dispatch a round; the round's uplink is a
            ``repro_torch.wire.payload.CodePayload``
  cohort  — cohort-streamed population rounds with the exactly associative
            Step 5 stats merge, scheduler-driven traffic (``run_traffic``)
            and open-ended continuous-ingest traffic (``run_continuous``)
  faults  — the chaos plane: ``FaultyChannel`` drops, duplicates,
            reorders, delays, corrupts and truncates uplinks under a
            ``FaultPlan``, each family on its own key substream, with the
            client retry loop

The retired ``IngestBuffer`` and ``PackedCodes`` raise on import, as in
the reference.
"""
from repro_torch.wire.payload import CodePayload

from .cohort import (CohortEngine, CohortPlan, CohortRound, ContinuousTick,
                     TrafficRound)
from .engine import (SimEngine, client_batch_size, replicate_clients,
                     stack_clients, unstack_clients)
from .faults import FAULT_KINDS, FaultPlan, FaultyChannel

__all__ = ["CodePayload", "CohortEngine", "CohortPlan", "CohortRound",
           "ContinuousTick", "FAULT_KINDS", "FaultPlan", "FaultyChannel",
           "SimEngine", "TrafficRound",
           "client_batch_size", "replicate_clients", "stack_clients",
           "unstack_clients"]

_TOMBSTONES = {
    "IngestBuffer": "repro_torch.server.store.CodeStore",
    "PackedCodes": "repro_torch.wire.payload.CodePayload",
}


def __getattr__(name):
    if name in _TOMBSTONES:
        raise ImportError(
            f"repro_torch.sim.{name} was removed; use {_TOMBSTONES[name]} "
            f"(the unified wire carrier/store)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
