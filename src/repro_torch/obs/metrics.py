"""Metrics plane: counters / gauges / histograms + the dispatch monitor.

Port of ``repro.obs.metrics``. The registry is deliberately tiny — plain
Python floats behind names — because it runs INSIDE the serving path:
``repro_torch.wire`` / ``repro_torch.server`` / ``repro_torch.sim.cohort``
update it per uplink and per round while a flight recorder is active.
Standard instruments:

  counter    monotonically increasing total (``uplinks_ingested``,
             ``wire_bytes``, ``merges``)
  gauge      last-written level (``uplink_queue_depth``,
             ``store_records``, ``store_bytes``)
  histogram  streaming count/total/min/max (+mean) of an observation
             (``round_ms``, ``decode_ms/v<version>``)

:func:`dispatch_monitor` wraps ``repro_torch.core.dvqae.encode`` and the
four codec entries of ``repro_torch.kernels.ops`` with counting shims:
COUNTED (not inferred) encoder passes and fused encode/decode/pack
dispatch numbers for any block of code, restored on exit, optionally
folded into a registry's counters. The port's callers reach those entries
through imports made at call time (``wire/session.py``, ``wire/codec.py``,
``wire/payload.py``, ``core/octopus.py::client_encode``), so the shims see
every call; a module-level ``from ... import encode_codes`` would escape
them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    __slots__ = ("count", "total", "min", "max")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {"count": self.count, "total": self.total, "mean": self.mean,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0}


class MetricsRegistry:
    """Name -> instrument, created on first touch."""

    def __init__(self):
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}

    # ---------------------------------------------------------- instruments

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge()
        return g

    def histogram(self, name: str) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram()
        return h

    # ----------------------------------------------------------- shorthand

    def inc(self, name: str, v: float = 1.0) -> None:
        self.counter(name).inc(v)

    def set_gauge(self, name: str, v: float) -> None:
        self.gauge(name).set(v)

    def observe(self, name: str, v: float) -> None:
        self.histogram(name).observe(v)

    def snapshot(self) -> Dict[str, Any]:
        """Plain-dict view (what the report CLI embeds in its JSON)."""
        return {
            "counters": {k: c.value for k, c in sorted(self.counters.items())},
            "gauges": {k: g.value for k, g in sorted(self.gauges.items())},
            "histograms": {k: h.as_dict()
                           for k, h in sorted(self.histograms.items())},
        }


# ---------------------------------------------------------- dispatch counts

class DispatchCounts:
    """Counted dispatch numbers for one monitored block of code.

    ``encoder_passes`` counts ``repro_torch.core.dvqae.encode``
    invocations (exactly one encoder pass per round); the ``*_dispatches``
    fields count the fused kernel entries in ``repro_torch.kernels.ops``.
    One facade round is ``(encoder_passes, encode_dispatches) == (1, 1)``.
    """

    __slots__ = ("encoder_passes", "encode_dispatches", "decode_dispatches",
                 "pack_dispatches", "unpack_dispatches")

    def __init__(self):
        for f in self.__slots__:
            setattr(self, f, 0)

    def as_dict(self) -> Dict[str, int]:
        return {f: getattr(self, f) for f in self.__slots__}

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={v}" for k, v in self.as_dict().items())
        return f"DispatchCounts({inner})"


class _DispatchMonitor:
    """Wraps the encoder + fused kernel entries with counting shims.

    The shims delegate unchanged (same args, same result objects), so
    monitored code is bit-identical to unmonitored code; originals are
    restored on exit even if the block raises. Supports the same
    attribute-patching composition the tests use (a monitor installed
    inside another monitor counts for both).
    """

    def __init__(self, metrics: Optional[MetricsRegistry]):
        self._metrics = metrics
        self.counts = DispatchCounts()
        self._saved = None

    def __enter__(self) -> DispatchCounts:
        from repro_torch.core import dvqae
        from repro_torch.kernels import ops
        c = self.counts

        def counting(real, field):
            def shim(*a, **kw):
                setattr(c, field, getattr(c, field) + 1)
                return real(*a, **kw)
            return shim

        self._saved = (dvqae.encode, ops.encode_codes, ops.decode_codes,
                       ops.pack_codes, ops.unpack_codes)
        dvqae.encode = counting(dvqae.encode, "encoder_passes")
        ops.encode_codes = counting(ops.encode_codes, "encode_dispatches")
        ops.decode_codes = counting(ops.decode_codes, "decode_dispatches")
        ops.pack_codes = counting(ops.pack_codes, "pack_dispatches")
        ops.unpack_codes = counting(ops.unpack_codes, "unpack_dispatches")
        return c

    def __exit__(self, *exc) -> None:
        from repro_torch.core import dvqae
        from repro_torch.kernels import ops
        (dvqae.encode, ops.encode_codes, ops.decode_codes,
         ops.pack_codes, ops.unpack_codes) = self._saved
        metrics = self._metrics
        if metrics is None:
            from .recorder import active
            rec = active()
            metrics = rec.metrics if rec is not None else None
        if metrics is not None:
            for name, n in self.counts.as_dict().items():
                if n:
                    metrics.inc(name, n)


def dispatch_monitor(*, metrics: Optional[MetricsRegistry] = None
                     ) -> _DispatchMonitor:
    """Count encoder passes and fused kernel dispatches in a block::

        with obs.dispatch_monitor() as counts:
            payload = client.round(batch)
        assert (counts.encoder_passes, counts.encode_dispatches) == (1, 1)

    With ``metrics`` given (or a flight recorder active), non-zero
    counts fold into that registry's counters on exit — the supported
    home of the fused-dispatch regression numbers.
    """
    return _DispatchMonitor(metrics)
