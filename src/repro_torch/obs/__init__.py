"""repro_torch.obs — flight recorder + metrics plane for the OCTOPUS
pipeline (port of ``repro.obs``, same exports, same trace schema).

Opt-in tracing of every uplink from encode dispatch to codebook merge:

    from repro_torch import obs

    with obs.recording("trace.jsonl"):
        client.round(batch)            # every layer logs to the trace

    with obs.dispatch_monitor() as counts:
        client.round(batch)
    assert (counts.encoder_passes, counts.encode_dispatches) == (1, 1)

Default is a no-op: ``obs.active()`` returns None and instrumented call
sites skip all event work. Setting ``$OCTOPUS_TRACE=<path>`` before the
process imports ``repro_torch.obs`` installs a recorder automatically.
Summaries: ``python -m repro_torch.obs.report trace.jsonl`` (or the
reference's ``python -m repro.obs.report``: the schema is shared). See
``recorder.py`` for the event schema and the §2.5 metadata-only capture
rule.
"""
from .metrics import (Counter, DispatchCounts, Gauge, Histogram,
                      MetricsRegistry, dispatch_monitor)
from .recorder import (ENV_VAR, EVENT_KINDS, PAYLOAD_META_FIELDS,
                       FlightRecorder, active, install, install_from_env,
                       payload_meta, recording, settle, uninstall)

__all__ = [
    "Counter",
    "DispatchCounts",
    "ENV_VAR",
    "EVENT_KINDS",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "PAYLOAD_META_FIELDS",
    "active",
    "dispatch_monitor",
    "install",
    "install_from_env",
    "payload_meta",
    "recording",
    "settle",
    "uninstall",
]

install_from_env()
