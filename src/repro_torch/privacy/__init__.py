"""repro_torch.privacy: the privacy red team (port of ``repro.privacy``).

The paper ASSERTS that transmitted codes carry no private component; this
package attacks that claim end to end and defends the server side:

  audit      the Thm. 1 computational adversary: train q(Y|Z), read off
             H(Y|Z) bits and re-identification accuracy
  tap        ``PayloadTap``: full-payload wire capture under the explicit
             ``$OCTOPUS_REDTEAM`` opt-in (normal traces stay
             metadata-only)
  attacks    membership- and attribute-inference attackers over captured
             ``CodePayload`` streams
  sweep      deterministic attack-advantage-vs-knob rows (IN strength, K,
             GSVQ grouping) + the leaky-control teeth check
  oblivious  ``ObliviousCodeStore``: access-pattern hiding over the
             sharded store, bit-exact with the plain store

``python -m repro_torch.privacy_redteam`` runs the guided tour.
"""
from .audit import (AdversaryMetrics, adversary_logits, evaluate_adversary,
                    init_adversary, privacy_audit, train_adversary, xent)
from .tap import (ENV_VAR as REDTEAM_ENV_VAR, PayloadTap, RedTeamOptInError,
                  TapRecord, redteam_enabled)
from .attacks import (AttackReport, attribute_inference,
                      membership_inference, payload_histograms,
                      sample_labels, shadow_attack)
from .oblivious import ObliviousCodeStore
from .sweep import (attribute_point, encode_partial, harness_matches_wire,
                    make_codec, membership_point, oblivious_point, run_sweep)

__all__ = [
    "AdversaryMetrics", "adversary_logits", "evaluate_adversary",
    "init_adversary", "privacy_audit", "train_adversary", "xent",
    "REDTEAM_ENV_VAR", "PayloadTap", "RedTeamOptInError", "TapRecord",
    "redteam_enabled",
    "AttackReport", "attribute_inference", "membership_inference",
    "payload_histograms", "sample_labels", "shadow_attack",
    "ObliviousCodeStore",
    "attribute_point", "encode_partial", "harness_matches_wire",
    "make_codec", "membership_point", "oblivious_point", "run_sweep",
]
