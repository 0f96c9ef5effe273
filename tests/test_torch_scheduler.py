"""The port's traffic scheduler (``repro_torch.server.scheduler``).

* The numpy threefry2x32 behind ``_prng_key`` / ``_fold_in`` /
  ``_rng_from_key`` gives ``jax.random``'s key words and the same numpy
  streams, over seeds, rounds and purposes.
* ``RoundScheduler`` emits the reference's event stream bit for bit from
  the same key: participants, delays, drops, joins and leaves, for all
  four ``STANDARD_SCENARIOS``, a Poisson ``rate`` scheduler with a
  ``quantum``, and a ``DiurnalProfile``.
* Each draw owns its substream: the knob isolation and ``cohort_rng``
  isolation of ``tests/test_server.py``.
"""
import numpy as np
import pytest

import jax  # noqa: E402

from repro.server import scheduler as J  # noqa: E402
from repro_torch.server import scheduler as S  # noqa: E402

SEEDS = (0, 1, 7, 123456, 2 ** 32 - 1)


def key_words(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(S._prng_key(seed),
                                  key_words(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("rounds", [(0, 1, 2, 3), (17, 255, 1000),
                                    (2 ** 31 - 1, 2 ** 32 - 1)])
def test_fold_in_and_streams_match_jax(seed, rounds):
    key = jax.random.PRNGKey(seed)
    for r in rounds:
        for purpose in range(1, 7):
            want = jax.random.fold_in(jax.random.fold_in(key, r), purpose)
            got = S._fold_in(S._fold_in(seed, r), purpose)
            np.testing.assert_array_equal(got, key_words(want))
            a = S._rng_from_key(got).random(4)
            b = J._rng_from_key(want).random(4)
            np.testing.assert_array_equal(a, b)


def test_keys_take_words_and_refuse_bad_ones():
    words = key_words(jax.random.fold_in(jax.random.PRNGKey(3), 9))
    np.testing.assert_array_equal(S._fold_in(words, 4), key_words(
        jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(3), 9), 4)))
    with pytest.raises(ValueError, match="seed"):
        S._prng_key(-1)
    with pytest.raises(ValueError, match="two uint32"):
        S._as_key(np.zeros(3, np.uint32))


def same_events(a, b, rounds):
    for _ in range(rounds):
        ea, eb = a.step(), b.step()
        assert ea.round == eb.round
        for fa, fb in zip(ea[1:], eb[1:]):
            np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))
        np.testing.assert_array_equal(a.active, b.active)


@pytest.mark.parametrize("name", sorted(J.STANDARD_SCENARIOS))
def test_standard_scenarios_emit_the_reference_stream(name):
    sc, jsc = S.STANDARD_SCENARIOS[name], J.STANDARD_SCENARIOS[name]
    assert sc.merge_every == jsc.merge_every
    assert vars(sc.sched) == vars(jsc.sched)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 2)
    same_events(S.RoundScheduler(32, sc.sched, key=key_words(key)),
                J.RoundScheduler(32, jsc.sched, key=key), 16)


@pytest.mark.parametrize("quantum", [1, 4])
def test_poisson_rate_scheduler_matches_reference(quantum):
    kw = dict(rate=11.0, straggler_prob=0.4, max_delay=2, drop_prob=0.1,
              leave_prob=0.2, join_prob=0.5, participation=0.25)
    port = S.RoundScheduler(48, S.SchedulerConfig(**kw), key=7,
                            quantum=quantum)
    ref = J.RoundScheduler(48, J.SchedulerConfig(**kw),
                           key=jax.random.PRNGKey(7), quantum=quantum)
    assert port.k == ref.k
    same_events(port, ref, 20)


def test_diurnal_profile_matches_reference():
    prof = S.DiurnalProfile(period=8, trough=0.25, peak=1.0, phase=2)
    jprof = J.DiurnalProfile(period=8, trough=0.25, peak=1.0, phase=2)
    assert [prof.fraction(t) for t in range(9)] == \
        [jprof.fraction(t) for t in range(9)]
    cfg = dict(participation=0.5, straggler_prob=0.3, drop_prob=0.2)
    port = S.RoundScheduler(64, S.SchedulerConfig(**cfg), key=5,
                            profile=prof, quantum=8)
    ref = J.RoundScheduler(64, J.SchedulerConfig(**cfg),
                           key=jax.random.PRNGKey(5), profile=jprof,
                           quantum=8)
    counts = []
    for _ in range(8):
        counts.append(port.round_k())
        same_events(port, ref, 1)
    assert all(c % 8 == 0 for c in counts) and len(set(counts)) > 1


def test_participation_above_the_slots_raises():
    with pytest.raises(ValueError, match="slots"):
        S.RoundScheduler(4, S.SchedulerConfig(participation=2.0), key=0)


def test_scheduler_streams_are_knob_isolated():
    """Toggling the straggler and drop knobs leaves the participant and
    churn draws as they were (tests/test_server.py's contract)."""
    base = S.SchedulerConfig(participation=0.5, leave_prob=0.3,
                             join_prob=0.4)
    noisy = S.SchedulerConfig(participation=0.5, leave_prob=0.3,
                              join_prob=0.4, straggler_prob=0.9,
                              max_delay=3, drop_prob=0.5)
    a = S.RoundScheduler(16, base, key=3)
    b = S.RoundScheduler(16, noisy, key=3)
    for _ in range(12):
        ea, eb = a.step(), b.step()
        np.testing.assert_array_equal(ea.participants, eb.participants)
        np.testing.assert_array_equal(ea.joined, eb.joined)
        np.testing.assert_array_equal(ea.left, eb.left)


def test_cohort_rng_does_not_advance_population_streams():
    cfg = S.SchedulerConfig(participation=0.5, straggler_prob=0.5,
                            drop_prob=0.2, leave_prob=0.3, join_prob=0.4)
    a = S.RoundScheduler(16, cfg, key=4)
    b = S.RoundScheduler(16, cfg, key=4)
    ref = J.RoundScheduler(16, J.SchedulerConfig(**vars(cfg)),
                           key=jax.random.PRNGKey(4))
    for _ in range(10):
        got = b.cohort_rng().random(100)          # cohort draws on b only
        np.testing.assert_array_equal(got, ref.cohort_rng().random(100))
        ea, eb = a.step(), b.step()
        ref.step()
        for fa, fb in zip(ea, eb):
            np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))


def test_scheduler_shapes_and_roster_invariants():
    cfg = S.SchedulerConfig(participation=0.25, straggler_prob=1.0,
                            max_delay=2, leave_prob=0.5, join_prob=0.1)
    s = S.RoundScheduler(8, cfg, key=1)
    assert s.k == 2
    for _ in range(20):
        ev = s.step()
        assert ev.participants.shape == (2,)
        assert s.active[ev.participants].all()
        assert s.active.sum() >= s.k
        assert ((1 <= ev.delays) & (ev.delays <= 2)).all()
