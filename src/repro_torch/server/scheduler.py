"""Production-traffic round scheduler: participation, stragglers, churn.

Port of ``repro.server.scheduler``. ``RoundScheduler`` turns the traffic
knobs into a deterministic per-round event stream that the async code
server and the cohort engine replay: a fraction of the population
participates per round, some uplinks arrive rounds late (stragglers), some
never arrive (radio loss), and the population churns as devices enroll and
disappear.

Determinism: the whole schedule is a pure function of the constructor key.
Every per-round draw has its OWN substream (``fold_in(fold_in(key, round),
purpose)``): churn, participant choice, straggler delays, drops, arrivals
and cohort draws never share a Generator, so toggling one knob cannot
perturb another's draws.

The reference folds its key with ``jax.random.fold_in`` and seeds numpy
from the folded key's two uint32 words. The PRNG is threefry2x32 (20
rounds), which :mod:`repro_torch.prng` implements in numpy: ``PRNGKey(s)``
is the word pair ``[0, s]`` and ``fold_in(k, d)`` is ``threefry2x32(k, [0,
d])``, so the port emits the reference's event stream bit for bit from the
same key. The bookkeeping is host logic and stays numpy, as in the reference.

Shapes stay static: exactly ``k = max(1, round(participation * n_slots))``
participants are drawn per round from the ACTIVE slots, and leaves are
capped to keep at least ``k`` slots active. With a :class:`DiurnalProfile`
the per-round count arrives in whole ``quantum``-sized blocks (cohorts);
with ``rate`` it is an open-ended Poisson draw.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import numpy as np

from repro_torch.prng import as_key as _as_key
from repro_torch.prng import fold_in as _fold_in
from repro_torch.prng import prng_key as _prng_key  # noqa: F401 (callers)


@dataclass(frozen=True)
class SchedulerConfig:
    participation: float = 1.0   # fraction of slots drawn per round
    straggler_prob: float = 0.0  # P(an uplink is delayed >= 1 round)
    max_delay: int = 3           # truncated-geometric delay support
    delay_p: float = 0.5         # geometric continue-probability
    drop_prob: float = 0.0       # P(an uplink never arrives)
    leave_prob: float = 0.0      # per-active-slot P(depart) per round
    join_prob: float = 0.0       # per-inactive-slot P(enroll) per round
    rate: Optional[float] = None  # open-ended traffic: mean arrivals a tick
    #                               (Poisson; overrides `participation`'s
    #                               fixed per-round count, 0 ticks happen)


class RoundEvent(NamedTuple):
    """Everything that happens to the population in one round."""
    round: int
    participants: np.ndarray     # (k,) slot ids drawn this round
    delays: np.ndarray           # (k,) rounds until the uplink lands
    dropped: np.ndarray          # (k,) bool: uplink lost entirely
    joined: np.ndarray           # slot ids that (re-)enrolled this round
    left: np.ndarray             # slot ids that departed this round


# -------------------------------------------------------------------- keys

def _rng_from_key(key) -> np.random.Generator:
    """Host Generator seeded from a key's two uint32 words, as the
    reference seeds it from ``jax.random.key_data``."""
    return np.random.default_rng(_as_key(key))


# one substream per draw purpose: folding the purpose tag AFTER the round
# index gives every (round, purpose) pair an independent Generator
_STREAM_CHURN = 1
_STREAM_PARTICIPANTS = 2
_STREAM_DELAYS = 3
_STREAM_DROPS = 4
_STREAM_COHORTS = 5
_STREAM_ARRIVALS = 6


@dataclass(frozen=True)
class DiurnalProfile:
    """Cosine day/night participation swing: ``fraction(t)`` oscillates
    between ``trough`` and ``peak`` with period ``period`` rounds, peaking
    at round ``phase``."""
    period: int = 24
    trough: float = 0.25
    peak: float = 1.0
    phase: int = 0

    def fraction(self, round_idx: int) -> float:
        c = math.cos(2.0 * math.pi * (round_idx - self.phase) / self.period)
        return self.trough + (self.peak - self.trough) * 0.5 * (1.0 + c)


class RoundScheduler:
    """Deterministic event stream over a fixed slot array.

    ``key`` is an int seed (``PRNGKey(seed)``) or a uint32[2] key.
    ``profile`` (optional :class:`DiurnalProfile`) modulates the per-round
    participant count; ``quantum`` keeps that count a whole multiple (the
    cohort size).
    """

    def __init__(self, n_slots: int, cfg: SchedulerConfig = SchedulerConfig(),
                 *, key, profile: Optional[DiurnalProfile] = None,
                 quantum: int = 1):
        self.n_slots = int(n_slots)
        self.cfg = cfg
        self._key = _as_key(key)
        self.round = 0
        self.active = np.ones(self.n_slots, dtype=bool)
        self.profile = profile
        self.quantum = int(quantum)
        self.k = max(1, int(round(cfg.participation * self.n_slots)))
        if self.quantum > 1:
            self.k = max(self.quantum,
                         (self.k // self.quantum) * self.quantum)
        if self.k > self.n_slots:
            raise ValueError(f"participation {cfg.participation} needs "
                             f"{self.k} > {self.n_slots} slots")

    def _rng(self, purpose: int) -> np.random.Generator:
        """Fresh Generator for one (round, purpose) draw."""
        return _rng_from_key(_fold_in(_fold_in(self._key, self.round),
                                      purpose))

    def round_k(self) -> int:
        """This round's participant count: base ``k`` scaled by the
        diurnal profile, in whole ``quantum`` blocks (>= one block); with
        ``cfg.rate`` an open-ended Poisson arrival draw on its own
        substream (quiet ticks with k = 0 happen)."""
        if self.cfg.rate is not None:
            k = int(self._rng(_STREAM_ARRIVALS).poisson(self.cfg.rate))
            if self.quantum > 1:
                k = (k // self.quantum) * self.quantum
            return min(k, self.n_slots)
        if self.profile is None:
            return self.k
        want = self.profile.fraction(self.round) * self.k
        q = self.quantum
        return max(q, int(round(want / q)) * q)

    def step(self) -> RoundEvent:
        cfg = self.cfg

        # churn first: the participant draw sees this round's roster
        joined = np.array([], dtype=int)
        left = np.array([], dtype=int)
        if cfg.join_prob > 0.0 or cfg.leave_prob > 0.0:
            rng = self._rng(_STREAM_CHURN)
            if cfg.join_prob > 0.0:
                idle = np.nonzero(~self.active)[0]
                joined = idle[rng.random(idle.size) < cfg.join_prob]
                self.active[joined] = True
            if cfg.leave_prob > 0.0:
                act = np.nonzero(self.active)[0]
                cand = act[rng.random(act.size) < cfg.leave_prob]
                # keep at least k slots active; the cap drops a RANDOM
                # subset of the would-be leavers
                n_spare = int(self.active.sum()) - self.k
                left = rng.permutation(cand)[:max(0, min(cand.size,
                                                         n_spare))]
                self.active[left] = False

        k = self.round_k()
        act = np.nonzero(self.active)[0]
        participants = self._rng(_STREAM_PARTICIPANTS).choice(
            act, size=min(k, act.size), replace=False)
        participants.sort()
        k = participants.size

        delays = np.zeros(k, dtype=int)
        if cfg.straggler_prob > 0.0:
            rng = self._rng(_STREAM_DELAYS)
            slow = rng.random(k) < cfg.straggler_prob
            # truncated geometric on {1..max_delay}
            d = rng.geometric(1.0 - cfg.delay_p, size=k)
            delays = np.where(slow, np.minimum(d, cfg.max_delay), 0)
        dropped = (self._rng(_STREAM_DROPS).random(k) < cfg.drop_prob
                   if cfg.drop_prob > 0.0 else np.zeros(k, dtype=bool))

        ev = RoundEvent(round=self.round, participants=participants,
                        delays=delays, dropped=dropped,
                        joined=np.sort(joined), left=np.sort(left))
        self.round += 1
        return ev

    def cohort_rng(self) -> np.random.Generator:
        """Substream reserved for cohort-level draws; consuming it never
        advances the churn / participant / delay / drop streams."""
        return self._rng(_STREAM_COHORTS)


class Scenario(NamedTuple):
    """A named traffic profile: scheduler knobs + merge cadence."""
    sched: SchedulerConfig
    merge_every: int


STANDARD_SCENARIOS: Dict[str, Scenario] = {
    # every slot reports every round, no failures: the sync baseline
    "full": Scenario(SchedulerConfig(), merge_every=4),
    # 25 % participation, half the uplinks straggle 1-2 rounds, 1-in-8 drop
    "partial": Scenario(SchedulerConfig(participation=0.25,
                                        straggler_prob=0.5, max_delay=2,
                                        drop_prob=0.125), merge_every=4),
    # device churn with frequent merges: stragglers and re-joiners carry
    # codebook-version lag into the store
    "churn": Scenario(SchedulerConfig(participation=0.5,
                                      straggler_prob=0.5, max_delay=3,
                                      leave_prob=0.2, join_prob=0.5),
                      merge_every=2),
    # an on-path adversary taps the wire while the population churns
    "adversary": Scenario(SchedulerConfig(participation=0.5,
                                          straggler_prob=0.3, max_delay=2,
                                          drop_prob=0.1, leave_prob=0.1,
                                          join_prob=0.25), merge_every=2),
}
