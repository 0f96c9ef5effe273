"""Privacy red team: attack the §2.5 claim, then hide the access pattern.

    OCTOPUS_REDTEAM=1 PYTHONPATH=src python -m repro_torch.privacy_redteam

The PyTorch copy of ``examples/privacy_redteam.py``, with its knobs and
checks, on ``cuda`` (``run(device="cpu")`` runs it on the CPU). OCTOPUS
claims transmitted codes carry no private component; this driver plays the
adversary instead of trusting the claim:

  1. drive the ``adversary`` standing scenario's traffic (8 slots, 4
     rounds, the scheduler key 42, so the participants are the
     reference's) through two ``PayloadTap`` s, which record FULL packed
     payloads under the explicit ``OCTOPUS_REDTEAM`` opt-in: one on the
     privatized sequence codec (IN on), one on the leaky control (IN off),
     both at K = 32 with the same weights;
  2. train attribute- and membership-inference attackers on the captured
     streams: against the privatized wire they score about chance, against
     the leaky control they must NOT (the harness has teeth);
  3. measure the ``ObliviousCodeStore`` against the plain sharded store:
     the same bits out, at a measured touch-ratio cost.

It holds the example's three checks: leaky advantage > 0.2, privatized
|advantage| < 0.2, oblivious parity 1.0. Set ``OCTOPUS_TRACE=redteam.jsonl``
to flight-record the run: the trace shows ``tap`` / ``attack`` events
(payload metadata and scalar results only).
"""
from __future__ import annotations

import os

import torch

from repro_torch import obs, resolve_device
from repro_torch.privacy import sweep as SW
from repro_torch.privacy.attacks import attribute_inference
from repro_torch.privacy.tap import ENV_VAR, PayloadTap
from repro_torch.server import STANDARD_SCENARIOS, RoundScheduler

N_SLOTS, ROUNDS, BATCH, K = 8, 4, 24, 32
SCHED_KEY = 42
ATTACK_STEPS = 120


def tap_scenario(*, device, seed: int = 0, n_slots: int = N_SLOTS,
                 rounds: int = ROUNDS, batch: int = BATCH, K: int = K):
    """Step 1: ``rounds`` of the ``adversary`` scenario; every participant
    transmits one batch through the privatized and the leaky codec, each
    captured by its own tap. -> (tap, leaky tap, participants a round)."""
    sched = RoundScheduler(n_slots, STANDARD_SCENARIOS["adversary"].sched,
                           key=SCHED_KEY)
    _, _, srv = SW.make_codec(seed, K=K, device=device)
    _, _, srv_leaky = SW.make_codec(seed, K=K, apply_in=False, device=device)
    draw = SW.styled_population(seed, batch)
    tap, tap_leaky = PayloadTap(), PayloadTap()
    participants = []
    for _ in range(rounds):
        ev = sched.step()
        participants.append(ev.participants.tolist())
        for c in participants[-1]:
            sty = c % SW.N_STYLES
            x = draw(c)
            tap.capture(srv.deploy(client_id=c).transmit(x),
                        client=c, style=sty)
            tap_leaky.capture(srv_leaky.deploy(client_id=c).transmit(x),
                              client=c, style=sty)
    return tap, tap_leaky, participants


def run(*, device=None, seed: int = 0, steps: int = ATTACK_STEPS) -> dict:
    """The tour once; raises if a check fails. Needs the
    ``OCTOPUS_REDTEAM`` opt-in (``main`` sets it). Returns the taps, the
    three attack reports and the oblivious store's figures."""
    dev = resolve_device(device)
    rec = obs.install_from_env()                 # OCTOPUS_TRACE=... records
    tap, tap_leaky, participants = tap_scenario(device=dev, seed=seed)
    print(f"tapped {len(tap)} uplinks, {tap.nbytes} B of packed codes")

    kw = dict(attribute="style", n_classes=SW.N_STYLES, n_atoms=K,
              steps=steps)
    leaky = attribute_inference(torch.Generator().manual_seed(seed),
                                tap_leaky, **kw)
    priv = attribute_inference(torch.Generator().manual_seed(seed + 1), tap,
                               **kw)
    print(f"attribute attack, leaky control:  acc {leaky.accuracy:.2f} "
          f"(chance {leaky.chance:.2f}) -> advantage {leaky.advantage:+.2f}")
    print(f"attribute attack, privatized:     acc {priv.accuracy:.2f} "
          f"(chance {priv.chance:.2f}) -> advantage {priv.advantage:+.2f}")
    if not leaky.advantage > 0.2:
        raise AssertionError(f"the harness lost its teeth: {leaky}")
    if not abs(priv.advantage) < 0.2:
        raise AssertionError(f"the privatized wire leaked: {priv}")

    mem = SW.membership_point(torch.Generator().manual_seed(seed + 2),
                              seed=seed, strength=0.0, steps=steps,
                              device=dev)
    print(f"membership (leaky wire):          acc {mem.accuracy:.2f} "
          f"(chance {mem.chance:.2f}) -> advantage {mem.advantage:+.2f}")

    oh = SW.oblivious_point(seed=seed, device=dev)
    if oh["parity_bitexact"] != 1.0:
        raise AssertionError("the oblivious store answered differently "
                             "from the plain store")
    print(f"oblivious store: bit-exact with plain store; "
          f"touch ratio {oh['partition_touch_ratio']:.1f}x, "
          f"get wall ratio {oh['get_wall_ratio']:.1f}x")
    if rec is not None:
        print(f"trace: {rec.n_events} events -> {rec.path} "
              f"(tap/attack events are metadata-only)")
    return {"tap": tap, "tap_leaky": tap_leaky, "participants": participants,
            "leaky": leaky, "privatized": priv, "membership": mem,
            "oblivious": oh}


def main() -> None:
    os.environ.setdefault(ENV_VAR, "1")          # the explicit opt-in
    run()


if __name__ == "__main__":
    main()
