"""TOMBSTONE: the privacy toolkit lives in ``repro_torch.privacy``.

Port of ``repro.core.privacy``. The Thm. 1 computational adversary
(§2.7.2) is ``repro_torch.privacy.audit``, the classifier core behind both
the paired :func:`repro_torch.privacy.privacy_audit` and the wire-level
inference attacks (``repro_torch.privacy.attacks``). Importing a moved
name from here raises ``ImportError`` with the new location.
"""
from __future__ import annotations

_TOMBSTONES = {
    name: f"repro_torch.privacy.{name}"
    for name in ("AdversaryMetrics", "init_adversary", "adversary_logits",
                 "xent", "train_adversary", "evaluate_adversary",
                 "privacy_audit")
}


def __getattr__(name):
    if name in _TOMBSTONES:
        raise ImportError(
            f"repro_torch.core.privacy.{name} moved; use "
            f"{_TOMBSTONES[name]}: the red-team subsystem owns the Thm. 1 "
            f"adversary, see repro_torch.privacy")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
