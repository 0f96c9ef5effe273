"""Flight recorder: a structured JSONL event log of the OCTOPUS pipeline.

Port of ``repro.obs.recorder``. The events, their fields and the JSONL
layout are the reference's, so either package's report reads the other's
traces. Two things are the port's own: an event refuses torch tensors as it
refuses arrays, and :func:`settle` waits for the card before a site times
an event (where the reference calls ``jax.block_until_ready``), only while a
recorder is active, so untraced runs stay asynchronous.

Every run so far computed its numbers AFTER the fact (benchmarks/run.py
re-deriving throughput from wall-clock deltas); the pipeline itself kept
no record of what happened. The recorder is that record: one JSON object
per line, one line per event, covering the whole uplink life cycle —

  ``round``    one scheduler/population round (dur_ms, participant and
               byte ledger, queue depth, merged version)
  ``encode``   one fused encode dispatch (a cohort's or a client's
               Steps 3-5 tail) with the emitted payload's metadata
  ``uplink``   one :class:`repro_torch.wire.payload.CodePayload` hitting
               the wire —
               version / nbytes / bits / n_records / privatized (+ the
               wire revision and delivery fate). This is the captured
               stream a membership-inference harness replays: metadata
               ONLY, never the packed words, labels, latents or raw
               data, so the observability plane itself honors §2.5.
  ``ingest``   one payload landing in the server's versioned store
  ``decode``   one fused decode dispatch (per codebook-version group)
  ``merge``    one Step-5 dictionary merge registering a new version
  ``admission`` one admission verdict at the continuous-ingest door
               (accepted / migrated / deferred / rejected + reason +
               queue depth) — refusals stay §2.8-witnessed
  ``migration`` a rolling codebook-upgrade window opening or closing
               (src / dst versions, policy, leftover src records)
  ``fault``    the chaos plane injecting one fault into one uplink
               (``fault`` = drop / duplicate / reorder / delay /
               corrupt / truncate, plus the victim's nbytes)
  ``retry``    a client scheduling a retransmit of a transient-refused
               envelope (client_id / seq / attempt / backoff ticks)
  ``recovery`` one crash recovery completing (snapshot tick, journal
               entries replayed, wall duration)
  ``tap``      a red-team ``PayloadTap`` capturing
               one payload off the wire (capture count + the payload's
               METADATA — the tap announces itself in the trace, but
               the captured words live only in the opted-in tap)
  ``attack``   one inference attack scored (attack name, accuracy,
               chance, advantage — scalar results, never features)

Zero-overhead default: no recorder is installed unless the process opts
in (:func:`install` / :func:`recording` / the ``OCTOPUS_TRACE`` env
var). Instrumented call sites guard on ``active() is None`` — one global
read per site, no event dict, no timestamp, no allocation on the
disabled path. Instrumentation never touches RNG streams and never
forces a different computation, so traced and untraced runs are
bit-identical (pinned by tests/test_obs.py).

Spans are plain events carrying ``dur_ms`` (and a ``span`` id when
nesting matters); :meth:`FlightRecorder.span` times a ``with`` block and
emits the event at exit.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import IO, Any, Dict, Optional, Union

from .metrics import MetricsRegistry

EVENT_KINDS = ("round", "encode", "uplink", "ingest", "decode", "merge",
               "admission", "migration", "fault", "retry", "recovery",
               "tap", "attack")

#: uplink/ingest events carry EXACTLY this payload metadata — the §2.5
#: boundary of the observability plane (no words, no labels, no latents)
PAYLOAD_META_FIELDS = ("version", "nbytes", "bits", "n_records",
                       "privatized", "wire", "count")


def payload_meta(payload) -> Dict[str, Any]:
    """A :class:`~repro_torch.wire.payload.CodePayload`'s wire METADATA as
    a flat dict of plain ints and bools.

    Reads shape/dtype bookkeeping only — the packed words never leave
    the carrier, and label channels are deliberately not captured.
    """
    return {
        "version": int(payload.version),
        "nbytes": int(payload.nbytes),
        "bits": int(payload.bits),
        "n_records": int(payload.n_records),
        "privatized": bool(payload.privatized),
        "wire": int(payload.wire),
        "count": int(payload.count),
    }


class _Span:
    """Times a ``with`` block; emits ONE event (kind + dur_ms) at exit."""

    __slots__ = ("_rec", "_kind", "_fields", "_t0")

    def __init__(self, rec: "FlightRecorder", kind: str, fields: dict):
        self._rec = rec
        self._kind = kind
        self._fields = fields

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._rec.event(self._kind,
                        dur_ms=(time.perf_counter() - self._t0) * 1e3,
                        **self._fields)


class FlightRecorder:
    """Appends structured events to a JSONL file, one line per event.

    ``path`` may be a filesystem path or an open text handle. Each line
    is ``{"kind": ..., "ts": <wall seconds>, "seq": <monotonic event
    index>, ...fields}``. The writer flushes per event so a crashed or
    killed run keeps everything recorded up to the failure. A
    :class:`~repro_torch.obs.metrics.MetricsRegistry` rides along
    (``.metrics``) for the counters/gauges/histograms the instrumented
    sites maintain while the recorder is active.
    """

    def __init__(self, path: Union[str, os.PathLike, IO[str]], *,
                 metrics: Optional[MetricsRegistry] = None):
        if hasattr(path, "write"):
            self._fh: IO[str] = path
            self._owns = False
            self.path = getattr(path, "name", "<stream>")
        else:
            self._fh = open(path, "a")
            self._owns = True
            self.path = os.fspath(path)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.n_events = 0
        self._lock = threading.Lock()

    # -------------------------------------------------------------- events

    def event(self, kind: str, **fields) -> Dict[str, Any]:
        """Emit one event; returns the dict that was written.

        Field values must be SCALARS (numbers / strings / bools / None):
        arrays, tensors and containers are refused outright, so no event
        kind —
        present or future — can smuggle packed words, label vectors or
        latents into a trace (§2.5 is enforced mechanically, not by
        call-site discipline).
        """
        for k, v in fields.items():
            if (isinstance(v, (list, tuple, set, dict, bytes, bytearray))
                    or getattr(v, "ndim", 0) or _is_tensor(v)):
                raise ValueError(
                    f"trace event {kind!r} field {k!r} carries a "
                    f"{type(v).__name__}; events are scalar-only — the "
                    f"observability plane never records words, labels or "
                    f"latents (§2.5)")
        ev = {"kind": kind, "ts": time.time()}
        ev.update(fields)
        with self._lock:
            ev["seq"] = self.n_events
            self.n_events += 1
            self._fh.write(json.dumps(ev, separators=(",", ":"),
                                      default=_jsonable) + "\n")
            self._fh.flush()
        return ev

    def span(self, kind: str, **fields) -> _Span:
        """``with rec.span("decode", version=3): ...`` — one event with
        the block's ``dur_ms`` at exit."""
        return _Span(self, kind, fields)

    def uplink(self, payload, **fields) -> Dict[str, Any]:
        """THE uplink event: one payload crossing the wire. Captures the
        carrier's metadata (:func:`payload_meta`) — never its words or
        label channels — plus caller context (round, delay, fate)."""
        meta = payload_meta(payload)
        self.metrics.inc("uplinks_sent")
        self.metrics.inc("wire_bytes", meta["nbytes"])
        return self.event("uplink", **meta, **fields)

    # ----------------------------------------------------------- lifecycle

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        if self._owns and not self._fh.closed:
            self._fh.close()

    def __enter__(self) -> "FlightRecorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _is_tensor(x) -> bool:
    """A torch tensor of any rank (torch is not imported for this: a
    process that never imported it holds none)."""
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


def _jsonable(x):
    """Last-resort coercion for numpy scalars riding in event fields
    (tensors never reach here: :meth:`FlightRecorder.event` refuses them)."""
    for attr in ("item",):
        if hasattr(x, attr):
            return x.item()
    return str(x)


def settle(*tensors) -> None:
    """Wait until the card has finished the work that produced ``tensors``
    (each on its own device), so that an event's ``dur_ms`` covers it: the
    port's ``jax.block_until_ready``. A no-op for CPU tensors. Sites call
    it only while a recorder is active."""
    torch = sys.modules.get("torch")
    if torch is None:
        return
    for dev in {t.device for t in tensors
                if isinstance(t, torch.Tensor) and t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


# ------------------------------------------------------- process singleton

_ACTIVE: Optional[FlightRecorder] = None


def active() -> Optional[FlightRecorder]:
    """The installed recorder, or None (the zero-overhead default).

    Instrumented sites guard every event behind ``active() is not
    None`` — when disabled, the entire cost is this global read.
    """
    return _ACTIVE


def install(rec: FlightRecorder) -> FlightRecorder:
    """Make ``rec`` the process-wide recorder all hooks report to."""
    global _ACTIVE
    _ACTIVE = rec
    return rec


def uninstall() -> Optional[FlightRecorder]:
    """Remove (and return) the installed recorder; does NOT close it."""
    global _ACTIVE
    rec, _ACTIVE = _ACTIVE, None
    return rec


class _Recording:
    """Context manager: install a fresh recorder, uninstall + close."""

    def __init__(self, path, **kw):
        self._rec = FlightRecorder(path, **kw)

    def __enter__(self) -> FlightRecorder:
        return install(self._rec)

    def __exit__(self, *exc) -> None:
        if _ACTIVE is self._rec:
            uninstall()
        self._rec.close()


def recording(path, **kw) -> _Recording:
    """``with obs.recording("trace.jsonl") as rec: ...`` — scoped
    tracing: every instrumented layer reports to ``rec`` inside the
    block, and the default reverts to no-op outside it."""
    return _Recording(path, **kw)


ENV_VAR = "OCTOPUS_TRACE"


def install_from_env() -> Optional[FlightRecorder]:
    """Install a recorder writing to ``$OCTOPUS_TRACE`` if set (how CI
    traces an unmodified example end to end). No-op otherwise."""
    path = os.environ.get(ENV_VAR, "").strip()
    if not path or _ACTIVE is not None:
        return _ACTIVE
    return install(FlightRecorder(path))
