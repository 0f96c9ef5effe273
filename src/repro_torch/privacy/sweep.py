"""Deterministic leakage-vs-knob sweep: the ``BENCH_privacy.json`` rows.

Port of ``repro.privacy.sweep``. Attack-advantage curves over the three
§2.5-relevant knobs (disentanglement strength, codebook size K, GSVQ
grouping), plus the oblivious-store overhead rows, all on the linear
``sequence`` codec (d_model 12 -> M 8). That codec is the PROVABLY-leaky
control: with IN off, a per-instance channel shift (the style carrier
Eq. 4 strips) flows straight through the linear encoder into the code
stream, so the attribute attacker MUST score above chance there; if it
does not, the harness is broken, not the defense.

Everything is deterministic: codec weights come from
``convert.init_numpy_params`` at the codec's seed, population draws from
``np.random.default_rng(seed)`` as in the reference, attacks from the
``torch.Generator`` passed in, and the oblivious store's schedules from
its own seed. Entry points run on ``cuda`` unless ``device="cpu"``.

Two encode paths feed the tap:

  * the FACADE path (``OctopusClient.transmit``: one ``encode_codes``
    launch) for the headline leaky-vs-privatized rows;
  * a partial-IN HARNESS encoder for the knob curves:
    ``z_s = (1-s)·z + s·IN(z)``, quantized by ``vq_nearest`` (or GSVQ) and
    packed by ``pack_codes``; at s=0 and s=1 its words equal the facade's
    with ``apply_in`` off and on, asserted every sweep as the
    ``harness_matches_wire`` row.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import octopus as OC
from repro_torch.core.disentangle import instance_norm_latent
from repro_torch.core.dvqae import DVQAEConfig
from repro_torch.core.gsvq import gsvq_quantize
from repro_torch.core.vq import quantize
from repro_torch.server.store import ShardedCodeStore
from repro_torch.wire.payload import CodePayload
from repro_torch.wire.session import OctopusServer

from .attacks import AttackReport, attribute_inference, membership_inference
from .oblivious import ObliviousCodeStore
from .tap import PayloadTap

#: the linear codec's dimensions (the reference's test_wire.py privacy
#: regression)
D_MODEL = 12
M_LATENT = 8
T_SEQ = 10
N_CONTENT = 4
N_STYLES = 4
SHIFT_SCALE = 2.0      # style shift magnitude, IN-strippable by design


def make_codec(seed: int, *, K: int = 32, apply_in: bool = True,
               n_groups: int = 1, n_slices: int = 1, device=None):
    """(cfg, params, facade server) for one knob point on ``device``.
    Params depend only on ``seed`` and the shape knobs, never on
    ``apply_in``: the leaky and privatized variants share the codec's
    weights."""
    cfg = DVQAEConfig(kind="sequence", latent_dim=M_LATENT,
                      codebook_size=K, apply_in=apply_in,
                      n_groups=n_groups, n_slices=n_slices)
    srv = OctopusServer.init(seed, cfg, device=device, d_model=D_MODEL)
    return cfg, srv.state.params, srv


def n_atoms(cfg: DVQAEConfig) -> int:
    """The transmitted alphabet the attacker histograms over."""
    if cfg.n_groups > 1 or cfg.n_slices > 1:
        return cfg.n_groups
    return cfg.codebook_size


def client_batch(rng: np.random.Generator, protos: np.ndarray,
                 shift: np.ndarray, batch: int, noise: float = 0.05):
    """One client's local batch -> ((batch, T, D) float32 numpy, content
    labels): time-varying content prototypes (IN cannot strip those) + a
    constant-over-T channel shift (IN strips exactly those) + noise."""
    content = rng.integers(0, protos.shape[0], size=batch)
    x = protos[content] + noise * rng.normal(
        size=(batch,) + protos.shape[1:])
    x = x + shift[None, None, :]
    return x.astype(np.float32), content


def styled_population(seed: int, batch: int) -> Callable[[int], np.ndarray]:
    """A styled population's batches: ``draw(c)`` is client ``c``'s next
    batch, carrying style ``c % N_STYLES``. Prototypes, style shifts and
    batches come from ``np.random.default_rng(seed)`` in call order."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(N_CONTENT, T_SEQ, D_MODEL))
    shifts = rng.normal(size=(N_STYLES, D_MODEL)) * SHIFT_SCALE

    def draw(c: int) -> np.ndarray:
        return client_batch(rng, protos, shifts[c % N_STYLES], batch)[0]
    return draw


def encode_partial(params, cfg: DVQAEConfig, x, strength: float
                   ) -> CodePayload:
    """Harness encoder with a CONTINUOUS disentanglement-strength knob,
    on the device of ``params``: ``strength=0`` transmits VQ(z) (the leaky
    control), ``strength=1`` VQ(IN(z)); intermediate values interpolate
    the pre-VQ latent."""
    proj = params["encoder"].proj
    with torch.no_grad():
        z = torch.as_tensor(x, dtype=torch.float32, device=proj.device) \
            @ proj
        s = float(strength)
        z_s = (1.0 - s) * z + s * instance_norm_latent(z)
        if cfg.n_groups > 1 or cfg.n_slices > 1:
            idx = gsvq_quantize(z_s, params["codebook"],
                                n_groups=cfg.n_groups,
                                n_slices=cfg.n_slices).indices
        else:
            idx = quantize(z_s, params["codebook"]).indices
    return CodePayload.pack(idx[None], bits=OC.transmit_bits(cfg))


def harness_matches_wire(seed: int = 0, batch: int = 32, *,
                         device=None) -> bool:
    """Anchor the harness to the production wire: at both endpoints the
    packed WORDS must equal a real ``OctopusClient.transmit``'s."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(N_CONTENT, T_SEQ, D_MODEL))
    shift = rng.normal(size=(D_MODEL,)) * SHIFT_SCALE
    x, _ = client_batch(rng, protos, shift, batch)
    ok = True
    for s, apply_in in ((0.0, False), (1.0, True)):
        cfg, params, srv = make_codec(seed, apply_in=apply_in, device=device)
        wire = srv.deploy().transmit(x)
        harness = encode_partial(params, cfg, x, s)
        ok = ok and torch.equal(wire.payload, harness.payload)
    return ok


# ------------------------------------------------------------ attack points

class Capture(NamedTuple):
    """One population ``run_sweep`` captured: the tap, the codec, the
    harness strength behind its codes (a facade transmit's is 1 with IN on,
    0 off) and the client batches it encoded, in order."""
    tap: PayloadTap
    cfg: DVQAEConfig
    params: dict
    strength: float
    inputs: List[np.ndarray]


def capture_population(params, cfg: DVQAEConfig, *, strength: float,
                       n_clients: int, batch: int, seed: int,
                       encode=None) -> PayloadTap:
    """Tap one round of a styled population: client ``c`` carries style
    ``c % N_STYLES``; the tap's meta holds the attacker-side ground truth.
    ``encode(x) -> CodePayload`` overrides the harness encoder (the facade
    rows pass a real client's ``transmit``)."""
    draw = styled_population(seed, batch)
    tap = PayloadTap(allow=True)
    for c in range(n_clients):
        x = draw(c)
        p = encode(x) if encode is not None else \
            encode_partial(params, cfg, x, strength)
        tap.capture(p, client=c, style=c % N_STYLES)
    return tap


def population_capture(tap: PayloadTap, cfg: DVQAEConfig, params,
                       strength: float, *, n_clients: int, batch: int,
                       seed: int) -> Capture:
    """The :class:`Capture` of ``capture_population(..., seed=seed)``: its
    tap, with the batches redrawn from the same seed."""
    draw = styled_population(seed, batch)
    return Capture(tap, cfg, params, strength,
                   [draw(c) for c in range(n_clients)])


def attribute_point(generator: torch.Generator, *, seed: int, K: int = 32,
                    n_groups: int = 1, n_slices: int = 1,
                    strength: float = 1.0, n_clients: int = 8,
                    batch: int = 40, steps: int = 150, device=None,
                    keep: Optional[Callable[[Capture], None]] = None
                    ) -> AttackReport:
    """One knob point: build codec, capture a round, run the attribute
    attacker. Fully determined by (generator seed, seed, knobs). ``keep``,
    where given, receives the captured population."""
    cfg, params, _ = make_codec(seed, K=K, n_groups=n_groups,
                                n_slices=n_slices, device=device)
    pop = dict(n_clients=n_clients, batch=batch, seed=seed + 17)
    tap = capture_population(params, cfg, strength=strength, **pop)
    if keep is not None:
        keep(population_capture(tap, cfg, params, strength, **pop))
    return attribute_inference(generator, tap, attribute="style",
                               n_classes=N_STYLES, n_atoms=n_atoms(cfg),
                               steps=steps)


def membership_point(generator: torch.Generator, *, seed: int,
                     strength: float, n_members: int = 4,
                     n_shadow: int = 12, n_holdout: int = 8,
                     batch: int = 24, steps: int = 150,
                     device=None) -> AttackReport:
    """One membership point: members carry persistent per-client
    signatures across rounds; the attacker trains on a round-1 capture of
    members + shadow non-members and is tested on a LATER round of the
    members (fresh content, same signatures) plus never-seen holdout
    clients."""
    cfg, params, _ = make_codec(seed, K=32, device=device)
    rng = np.random.default_rng(seed + 53)
    protos = rng.normal(size=(N_CONTENT, T_SEQ, D_MODEL))
    member_sig = rng.normal(size=(n_members, D_MODEL)) * SHIFT_SCALE
    shadow_sig = rng.normal(size=(n_shadow, D_MODEL)) * SHIFT_SCALE
    holdout_sig = rng.normal(size=(n_holdout, D_MODEL)) * SHIFT_SCALE

    def rounds(tap, sigs, member):
        for i in range(sigs.shape[0]):
            x, _ = client_batch(rng, protos, sigs[i], batch)
            tap.capture(encode_partial(params, cfg, x, strength),
                        member=member)

    train = PayloadTap(allow=True)
    rounds(train, member_sig, 1)
    rounds(train, shadow_sig, 0)
    test = PayloadTap(allow=True)
    rounds(test, member_sig, 1)       # round 2: same members, new content
    rounds(test, holdout_sig, 0)      # fresh clients the attacker never saw
    return membership_inference(generator, train, test,
                                n_atoms=n_atoms(cfg), steps=steps)


# --------------------------------------------------------- oblivious point

def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def oblivious_point(*, seed: int, n_clients: int = 8, rounds: int = 2,
                    batch: int = 16, n_shards: int = 4,
                    device=None) -> Dict[str, float]:
    """Baseline-vs-oblivious measurement on one identical workload: the
    same ingest stream and the same (client, round) queries against a
    plain ``ShardedCodeStore`` and an :class:`ObliviousCodeStore`; parity
    is checked bit for bit. Each timed loop of gets ends in a device
    synchronize."""
    cfg, params, _ = make_codec(seed, K=32, device=device)
    dev = params["codebook"].device
    rng = np.random.default_rng(seed + 99)
    protos = rng.normal(size=(N_CONTENT, T_SEQ, D_MODEL))
    sigs = rng.normal(size=(n_clients, D_MODEL)) * SHIFT_SCALE
    plain = ShardedCodeStore(cfg, n_shards=n_shards, seed=seed)
    obl = ObliviousCodeStore(cfg, n_shards=n_shards, seed=seed,
                             oblivious_seed=7)
    for r in range(rounds):
        for c in range(n_clients):
            x, _ = client_batch(rng, protos, sigs[c], batch)
            p = encode_partial(params, cfg, x, 1.0)
            plain.add(p, client_ids=[c], round=r)
            obl.add(p, client_ids=[c], round=r)
    queries = [(c, r) for r in range(rounds) for c in range(n_clients)]
    # warm both paths before timing
    plain.get(*queries[0]), obl.get(*queries[0])
    _sync(dev)
    t0 = time.perf_counter()
    got_plain = [plain.get(c, r) for c, r in queries]
    _sync(dev)
    t_plain = time.perf_counter() - t0
    t0 = time.perf_counter()
    got_obl = [obl.get(c, r) for c, r in queries]
    _sync(dev)
    t_obl = time.perf_counter() - t0
    parity = torch.equal(plain.codes(), obl.codes())
    for (ia, va), (ib, vb) in zip(got_plain, got_obl):
        parity = parity and va == vb and torch.equal(ia, ib)
    oh = obl.overhead()
    oh.update(parity_bitexact=float(parity),
              get_wall_ratio=t_obl / max(t_plain, 1e-9),
              n_queries=float(len(queries)))
    return oh


# ---------------------------------------------------------------- the sweep

def run_sweep(generator: torch.Generator, *, quick: bool = False,
              seed: int = 0, device=None,
              captures: Optional[Dict[str, Capture]] = None
              ) -> List[Dict[str, object]]:
    """All ``BENCH_privacy.json`` rows: headline facade rows, the three
    knob curves, membership, and the oblivious-store overheads, as
    ``[{"name", "value", "extra"}, ...]``. Each attack takes its own
    generator, seeded from ``generator`` in row order (the reference splits
    its key into 64). ``captures``, where given, receives the population
    behind each facade and knob row under the row's name."""
    steps = 80 if quick else 150
    batch = 24 if quick else 40
    n_clients = 8
    rows: List[Dict[str, object]] = []
    seeds = iter(torch.randint(0, 2 ** 62, (64,), generator=generator)
                 .tolist())

    def gen():
        return torch.Generator().manual_seed(next(seeds))

    def keep(name):
        return None if captures is None else \
            (lambda cap: captures.__setitem__(name, cap))

    def row(name, value, **extra):
        rows.append({"name": name, "value": float(value), "extra": extra})

    def attack_rows(name, rep: AttackReport, **extra):
        row(name, rep.advantage, accuracy=rep.accuracy, chance=rep.chance,
            h_bits=rep.conditional_entropy_bits, n_test=rep.n_test, **extra)

    # anchor: the harness encoder IS the wire at both endpoints
    row("harness_matches_wire",
        1.0 if harness_matches_wire(seed, device=device) else 0.0)

    # headline: the REAL fused wire path, leaky control vs privatized (the
    # leaky row is the teeth check)
    for name, apply_in in (("leaky_control", False), ("privatized", True)):
        cfg, params, srv = make_codec(seed, K=32, apply_in=apply_in,
                                      device=device)
        pop = dict(n_clients=n_clients, batch=batch, seed=seed + 17)
        tap = capture_population(
            params, cfg, strength=1.0, encode=lambda x: srv.deploy()
            .transmit(x), **pop)
        if captures is not None:
            captures[f"{name}_advantage"] = population_capture(
                tap, cfg, params, float(apply_in), **pop)
        rep = attribute_inference(gen(), tap, attribute="style",
                                  n_classes=N_STYLES,
                                  n_atoms=n_atoms(cfg), steps=steps)
        attack_rows(f"{name}_advantage", rep, knob="facade",
                    apply_in=apply_in, captured_bytes=tap.nbytes)

    # knob 1: disentanglement strength s in [0, 1]
    strengths = (0.0, 0.5, 1.0) if quick else (0.0, 0.25, 0.5, 0.75, 1.0)
    for s in strengths:
        name = f"attr_advantage/disent_s{s:.2f}"
        rep = attribute_point(gen(), seed=seed, strength=s,
                              n_clients=n_clients, batch=batch, steps=steps,
                              device=device, keep=keep(name))
        attack_rows(name, rep, knob="disentanglement_strength", strength=s)

    # knob 2: codebook size K (leaky + privatized at each point)
    for K in ((16, 64) if quick else (16, 64, 256)):
        for tag, s in (("leaky", 0.0), ("priv", 1.0)):
            name = f"attr_advantage/K{K}_{tag}"
            rep = attribute_point(gen(), seed=seed, K=K, strength=s,
                                  n_clients=n_clients, batch=batch,
                                  steps=steps, device=device, keep=keep(name))
            attack_rows(name, rep, knob="codebook_size", K=K, strength=s)

    # knob 3: GSVQ grouping (G groups x S slices)
    gsvq = ((2, 1), (4, 2)) if quick else ((2, 1), (4, 1), (4, 2))
    for G, S in gsvq:
        for tag, s in (("leaky", 0.0), ("priv", 1.0)):
            name = f"attr_advantage/gsvq_g{G}s{S}_{tag}"
            rep = attribute_point(gen(), seed=seed, n_groups=G, n_slices=S,
                                  strength=s, n_clients=n_clients,
                                  batch=batch, steps=steps, device=device,
                                  keep=keep(name))
            attack_rows(name, rep, knob="gsvq_grouping", n_groups=G,
                        n_slices=S, strength=s)
    # membership (client re-identification), leaky vs privatized
    mem_kw = dict(n_members=3, n_shadow=8, n_holdout=5, batch=16) if quick \
        else dict(n_members=4, n_shadow=12, n_holdout=8, batch=24)
    for tag, s in (("leaky", 0.0), ("privatized", 1.0)):
        rep = membership_point(gen(), seed=seed, strength=s, steps=steps,
                               device=device, **mem_kw)
        attack_rows(f"membership_{tag}_advantage", rep, knob="membership",
                    strength=s, **mem_kw)

    # oblivious store: bit-exact parity + measured overhead
    oh = oblivious_point(seed=seed, batch=8 if quick else 16, device=device)
    row("oblivious_parity_bitexact", oh["parity_bitexact"])
    row("oblivious_touch_ratio", oh["partition_touch_ratio"],
        byte_touch_ratio=oh["byte_touch_ratio"], ops=oh["ops"])
    row("oblivious_get_overhead", oh["get_wall_ratio"],
        n_queries=oh["n_queries"], touched_bytes=oh["touched_bytes"],
        useful_bytes=oh["useful_bytes"])
    return rows
