"""PayloadTap: the red team's wire capture plane (FULL packed words).

Port of ``repro.privacy.tap``. The flight recorder
(:mod:`repro_torch.obs`) is metadata-only by design: §2.5 forbids words,
labels or latents in a normal trace. An inference attacker does not play
by that rule: it records every :class:`~repro_torch.wire.payload
.CodePayload` that crosses the wire, packed words and all, and trains
shadow classifiers on the captured stream (:mod:`repro_torch.privacy
.attacks`).

The tap is therefore a SEPARATE plane with an explicit opt-in: creating
one raises :class:`RedTeamOptInError` unless ``$OCTOPUS_REDTEAM`` is set
(or ``allow=True`` is passed by code that has already made the decision,
e.g. a test). Nothing in the pipeline constructs a tap implicitly. When a
tap IS active it announces itself with ``tap`` events that carry payload
metadata only (``obs.recorder.payload_meta``), never the captured words.

Two ways to capture:

  * explicitly: ``tap.capture(payload, style=..., member=...)`` records
    the payload plus attacker-side ground truth;
  * as a wiretap channel: ``PayloadTap(target=service)`` duck-types the
    continuous ``offer``/``tick``/``drain`` surface of a
    ``ContinuousIngestService``, so any producer that drives one can be
    observed unmodified.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, NamedTuple

import numpy as np

from repro_torch.obs import recorder as _obs
from repro_torch.wire.payload import CodePayload

#: the explicit opt-in gate: set to 1/true/yes/on to allow payload taps
ENV_VAR = "OCTOPUS_REDTEAM"


class RedTeamOptInError(RuntimeError):
    """Raised when a PayloadTap is constructed without the explicit
    ``$OCTOPUS_REDTEAM`` opt-in: full-payload capture is never ambient."""


def redteam_enabled() -> bool:
    """True iff the process opted into red-team capture via the env."""
    return os.environ.get(ENV_VAR, "").strip().lower() in (
        "1", "true", "yes", "on")


class TapRecord(NamedTuple):
    """One captured uplink: the FULL payload + attacker-side context."""
    payload: CodePayload
    meta: Dict[str, Any]


class PayloadTap:
    """Records full payloads from the wire, under explicit opt-in.

    ``meta`` passed to :meth:`capture` is the attacker's OWN bookkeeping
    (shadow-population ground truth: style/client/membership labels); it
    never touches the payload or the trace.
    """

    def __init__(self, *, allow: bool = False, target=None):
        if not (allow or redteam_enabled()):
            raise RedTeamOptInError(
                f"PayloadTap records FULL packed words off the wire; set "
                f"{ENV_VAR}=1 (or pass allow=True) to opt into red-team "
                f"capture; normal traces stay metadata-only (§2.5)")
        self.target = target
        self.records: List[TapRecord] = []

    # -------------------------------------------------------------- capture

    def capture(self, payload: CodePayload, **meta) -> CodePayload:
        """Record one payload (+ attacker ground truth); returns it so
        call sites can tap inline: ``srv.ingest(tap.capture(p))``."""
        self.records.append(TapRecord(payload=payload, meta=dict(meta)))
        rec = _obs.active()
        if rec is not None:
            rec.metrics.inc("tapped_payloads")
            rec.metrics.inc("tapped_bytes", payload.nbytes)
            rec.event("tap", n_captured=len(self.records),
                      **_obs.payload_meta(payload))
        return payload

    # ------------------------------------------- wiretap channel duck-typing

    def offer(self, payload, **kw):
        """Capture, then forward to the tapped service's admission door
        (requires ``target``). Client ids and the envelope riding in the
        offer are wire metadata an on-path adversary sees anyway: they go
        in the capture's meta."""
        if self.target is None:
            raise ValueError("PayloadTap.offer needs a target service; "
                             "construct PayloadTap(target=service)")
        ids = kw.get("client_ids")
        self.capture(payload,
                     client_ids=None if ids is None else
                     np.asarray(ids).reshape(-1).tolist(),
                     uplink_id=kw.get("uplink_id"))
        return self.target.offer(payload, **kw)

    def tick(self, *a, **kw):
        return self.target.tick(*a, **kw)

    def drain(self, *a, **kw):
        return self.target.drain(*a, **kw)

    def __getattr__(self, name):
        if self.__dict__.get("target") is None:
            raise AttributeError(name)
        return getattr(self.target, name)

    # ------------------------------------------------------------- captured

    def __len__(self) -> int:
        return len(self.records)

    @property
    def payloads(self) -> List[CodePayload]:
        return [r.payload for r in self.records]

    @property
    def nbytes(self) -> int:
        """Measured bytes the adversary captured (§2.8 accounting)."""
        return sum(r.payload.nbytes for r in self.records)

    def metas(self, key: str) -> List[Any]:
        """One meta value per captured record (missing -> None)."""
        return [r.meta.get(key) for r in self.records]

    def codes(self) -> np.ndarray:
        """All captured code indices, unpacked -> (N_samples, T...) int32
        numpy, the raw material the shadow classifiers train on."""
        parts = []
        for r in self.records:
            idx = r.payload.unpack().cpu().numpy()
            parts.append(idx.reshape((-1,) + idx.shape[2:]))
        if not parts:
            raise ValueError("empty tap")
        return np.concatenate(parts, axis=0)
