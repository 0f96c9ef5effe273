"""Port parity of the privacy red team (``repro_torch.privacy``): the tap,
the inference attacks, the sweep's harness encoder and the red-team
driver against ``repro.privacy`` and ``examples/privacy_redteam.py``.

Integer outputs (codes, words, histograms, labels, schedules) are held bit
for bit, codes but at near ties of the scores. The attacks draw their
permutation and probe from a ``torch.Generator`` where the reference draws
from ``jax.random``, so attack numbers are held to the example's own
thresholds, not to the reference's values; the probe's evaluation on the
same weights is held within 1e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import privacy as JP  # noqa: E402
from repro.core.octopus import ServerState as JState  # noqa: E402
from repro.optim.adamw import adamw_init as j_adamw_init  # noqa: E402
from repro.privacy import sweep as JSW  # noqa: E402
from repro.server import STANDARD_SCENARIOS as J_SCENARIOS  # noqa: E402
from repro.server import RoundScheduler as JScheduler  # noqa: E402
from repro.wire.payload import CodePayload as JPayload  # noqa: E402
from repro.wire.session import OctopusServer as JServer  # noqa: E402
import repro_torch.privacy as P  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch import privacy_redteam as R  # noqa: E402
from repro_torch.convert import (params_from_numpy,  # noqa: E402
                                 params_to_numpy, probe_from_numpy)
from repro_torch.core.disentangle import (  # noqa: E402
    instance_norm_latent)
from repro_torch.core.dvqae import DVQAEConfig  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.obs import report  # noqa: E402
from repro_torch.privacy import sweep as SW  # noqa: E402
from repro_torch.server import (ContinuousIngestService,  # noqa: E402
                                ShardedCodeStore)
from repro_torch.wire.payload import CodePayload  # noqa: E402

torch.set_num_threads(1)

CPU = "cpu"


@pytest.fixture(autouse=True)
def no_ambient_redteam(monkeypatch):
    monkeypatch.delenv(P.REDTEAM_ENV_VAR, raising=False)


def gen(seed):
    return torch.Generator().manual_seed(seed)


def payload(n_samples, *, bits=4, fill=0, clients=1):
    """A (clients, n_samples, 3) payload of codes ``fill + i`` mod 2^bits."""
    idx = (fill + np.arange(clients * n_samples * 3)) % (1 << bits)
    return CodePayload.pack(torch.from_numpy(
        idx.reshape(clients, n_samples, 3).astype(np.int32)), bits=bits)


# ------------------------------------------------------------------ the tap

def test_tap_requires_explicit_opt_in(monkeypatch):
    with pytest.raises(P.RedTeamOptInError, match="OCTOPUS_REDTEAM"):
        P.PayloadTap()
    assert not P.redteam_enabled()
    monkeypatch.setenv(P.REDTEAM_ENV_VAR, "yes")
    assert P.redteam_enabled()
    P.PayloadTap()                               # env opt-in
    monkeypatch.delenv(P.REDTEAM_ENV_VAR)
    P.PayloadTap(allow=True)                     # code opt-in
    with pytest.raises(P.RedTeamOptInError):     # the driver needs it too
        R.run(device=CPU)


def test_tap_captures_full_payload_but_traces_metadata_only(tmp_path):
    tap = P.PayloadTap(allow=True)
    p = payload(4, fill=7)
    with obs.recording(tmp_path / "t.jsonl") as rec:
        out = tap.capture(p, style=2, member=1)
        assert rec.metrics.snapshot()["counters"]["tapped_bytes"] == p.nbytes
    assert out is p
    assert len(tap) == 1 and tap.nbytes == p.nbytes
    assert tap.metas("style") == [2] and tap.metas("member") == [1]
    np.testing.assert_array_equal(tap.codes(),
                                  p.unpack().numpy().reshape(-1, 3))
    events = report.load_events(str(tmp_path / "t.jsonl"))
    assert [e["kind"] for e in events] == ["tap"]
    assert "payload" not in events[0] and "words" not in events[0]
    for v in events[0].values():
        assert isinstance(v, (int, float, bool, str, type(None)))
    assert {k: events[0][k] for k in obs.PAYLOAD_META_FIELDS} == \
        obs.payload_meta(p)


def test_tap_as_wiretap_channel():
    class Sink:
        def __init__(self):
            self.offers, self.ticks = [], 0

        def offer(self, payload, **kw):
            self.offers.append((payload, kw))
            return "ok"

        def tick(self):
            self.ticks += 1

        def drain(self):
            return "drained"

    sink = Sink()
    tap = P.PayloadTap(allow=True, target=sink)
    p = payload(2)
    assert tap.offer(p, client_ids=np.asarray([5]), uplink_id=(5, 0)) == "ok"
    assert sink.offers[0][0] is p
    tap.tick()
    assert sink.ticks == 1 and tap.drain() == "drained"
    assert tap.records[0].meta["client_ids"] == [5]
    assert tap.records[0].meta["uplink_id"] == (5, 0)
    with pytest.raises(ValueError, match="target"):
        P.PayloadTap(allow=True).offer(p)
    with pytest.raises(AttributeError):
        P.PayloadTap(allow=True).queue


def test_tap_in_front_of_ingest_service():
    """A tapped ContinuousIngestService answers, ledgers and stores exactly
    as an untapped one fed the same offers; the tap holds every offered
    byte."""
    _, _, srv = SW.make_codec(0, K=32, device=CPU)
    rng = np.random.default_rng(1)
    protos = rng.normal(size=(SW.N_CONTENT, SW.T_SEQ, SW.D_MODEL))
    offers = []
    for i in range(8):
        x, _ = SW.client_batch(rng, protos, rng.normal(size=SW.D_MODEL), 6)
        offers.append((srv.deploy(client_id=i % 3).transmit(x), i % 3,
                       (i % 3, i // 3), i % 2))
    offers.append(offers[2])                       # a retransmit

    def serve(front):
        out = [front.offer(p, client_ids=[c], uplink_id=u, delay=d)
               for p, c, u, d in offers]
        front.tick()
        front.drain()
        return out

    def service():
        return ContinuousIngestService(
            type(srv)(srv.state, srv.cfg, device=CPU,
                      store=ShardedCodeStore(srv.cfg, n_shards=2)),
            capacity=6)

    plain, tapped = service(), service()
    tap = P.PayloadTap(allow=True, target=tapped)
    a, b = serve(plain), serve(tap)
    assert [r.verdict for r in a] == [r.verdict for r in b]
    assert "duplicate" in [r.verdict for r in b]
    assert plain.verdicts == tapped.verdicts
    assert plain.verdict_bytes == tapped.verdict_bytes
    assert plain.queue.bytes_sent == tapped.queue.bytes_sent == tap.nbytes
    assert torch.equal(plain.wire.store.codes(), tapped.wire.store.codes())
    assert tap.tick_idx == tapped.tick_idx       # delegated attributes
    assert len(tap) == len(offers)


# -------------------------------------------------- histograms and labels

def to_ref(p: CodePayload) -> JPayload:
    return JPayload(payload=jnp.asarray(p.payload.numpy().view(np.uint32)),
                    bits=p.bits, shape=p.shape, n_records=p.n_records,
                    version=p.version, checksum=p.checksum)


@pytest.mark.parametrize("shape,bits,n_atoms", [
    ((1, 24, 10), 5, 32), ((3, 7, 10), 6, 64), ((1, 40, 10, 2), 2, 4),
    ((2, 5, 10, 1), 1, 2), ((1, 9, 10), 8, 200)])
def test_histograms_and_labels_match_reference(shape, bits, n_atoms):
    rng = np.random.default_rng(bits)
    payloads = [CodePayload.pack(torch.from_numpy(rng.integers(
        0, 1 << bits, shape).astype(np.int32)), bits=bits) for _ in range(3)]
    got = P.payload_histograms(payloads, n_atoms)
    want = JP.payload_histograms([to_ref(p) for p in payloads], n_atoms)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    n = shape[0] * shape[1]
    tap, jtap = P.PayloadTap(allow=True), JP.PayloadTap(allow=True)
    for i, p in enumerate(payloads):
        style = i if i < 2 else rng.integers(0, 4, n)
        tap.capture(p, style=style)
        jtap.capture(to_ref(p), style=style)
    np.testing.assert_array_equal(P.sample_labels(tap.records, "style"),
                                  JP.sample_labels(jtap.records, "style"))
    np.testing.assert_array_equal(tap.codes(), jtap.codes())
    with pytest.raises(KeyError):
        P.sample_labels(tap.records, "member")


# --------------------------------------------------- the harness encoder

def ref_params_flat(jparams):
    return {"encoder/proj": np.array(jparams["encoder"]["proj"]),
            "decoder/proj": np.array(jparams["decoder"]["proj"]),
            "codebook": np.array(jparams["codebook"])}


@pytest.mark.parametrize("K,G,S", [(32, 1, 1), (256, 1, 1), (32, 4, 2)])
def test_encode_partial_matches_reference(K, G, S):
    jcfg, jparams, _ = JSW.make_codec(0, K=K, n_groups=G, n_slices=S)
    cfg = DVQAEConfig(kind="sequence", latent_dim=SW.M_LATENT,
                      codebook_size=K, n_groups=G, n_slices=S)
    params = params_from_numpy(ref_params_flat(jparams), cfg, device=CPU)
    rng = np.random.default_rng(5)
    protos = rng.normal(size=(SW.N_CONTENT, SW.T_SEQ, SW.D_MODEL))
    shift = rng.normal(size=SW.D_MODEL) * SW.SHIFT_SCALE
    x, content = SW.client_batch(np.random.default_rng(6), protos, shift, 24)
    jx, jcontent = JSW.client_batch(np.random.default_rng(6), protos, shift,
                                    24)
    assert x.dtype == np.float32
    np.testing.assert_array_equal(x, np.asarray(jx))
    np.testing.assert_array_equal(content, jcontent)
    for s in (0.0, 0.5, 1.0):
        p = SW.encode_partial(params, cfg, x, s)
        jp = JSW.encode_partial(jparams, jcfg, jnp.asarray(x), s)
        assert (p.bits, p.shape, p.nbytes) == (jp.bits, jp.shape, jp.nbytes)
        codes = p.unpack().reshape(1, -1)
        jcodes = torch.from_numpy(np.array(jp.unpack()).reshape(1, -1))
        z = torch.from_numpy(x) @ params["encoder"].proj
        z_s = (1.0 - s) * z + s * instance_norm_latent(z)
        scores = ref.encode_scores(z_s.reshape(1, -1, SW.M_LATENT),
                                   params["codebook"][None],
                                   n_groups=G, n_slices=S)
        n_diff, n_out = ref.code_mismatches(codes, jcodes, scores)
        assert n_out == 0, f"s={s}: {n_diff} codes differ, {n_out} not ties"
        assert n_diff <= 1e-3 * codes.numel()


@pytest.mark.parametrize("seed", [0, 1])
def test_harness_matches_wire(seed):
    assert SW.harness_matches_wire(seed, device=CPU)
    assert SW.harness_matches_wire(seed, batch=16, device=CPU)


def test_make_codec_shares_weights_across_apply_in():
    _, a, _ = SW.make_codec(4, K=64, device=CPU)
    _, b, srv = SW.make_codec(4, K=64, apply_in=False, device=CPU)
    for k, v in params_to_numpy(a).items():
        np.testing.assert_array_equal(v, params_to_numpy(b)[k])
    assert SW.n_atoms(srv.cfg) == 64
    assert SW.n_atoms(srv.cfg.replace(n_groups=4, n_slices=2)) == 4


# -------------------------------------------------------------- attacks

def test_attack_teeth_at_the_sweeps_sizes():
    """The §2.5 gate at the quick sweep's sizes (batch 24, 80 steps): the
    leaky control well above chance, the privatized wire at chance, on the
    harness and on the real wire."""
    kw = dict(seed=0, n_clients=8, batch=24, steps=80, device=CPU)
    leaky = P.attribute_point(gen(0), strength=0.0, **kw)
    priv = P.attribute_point(gen(1), strength=1.0, **kw)
    assert leaky.advantage > 0.2, leaky
    assert abs(priv.advantage) < 0.2, priv
    assert leaky.conditional_entropy_bits < priv.conditional_entropy_bits
    for apply_in, check in ((False, lambda a: a > 0.2),
                            (True, lambda a: abs(a) < 0.2)):
        cfg, params, srv = SW.make_codec(0, apply_in=apply_in, device=CPU)
        tap = SW.capture_population(params, cfg, strength=1.0, n_clients=8,
                                    batch=24, seed=17,
                                    encode=lambda x: srv.deploy().transmit(x))
        rep = P.attribute_inference(gen(2), tap, attribute="style",
                                    n_classes=SW.N_STYLES, n_atoms=32,
                                    steps=80)
        assert check(rep.advantage), rep


def test_evaluate_adversary_matches_reference():
    jprobe = JP.init_adversary(jax.random.PRNGKey(1), 32, 4)
    probe = probe_from_numpy({k: np.array(v) for k, v in jprobe.items()},
                             device=CPU)
    rng = np.random.default_rng(2)
    feats = rng.random((200, 32)).astype(np.float32)
    labels = rng.integers(0, 4, 200).astype(np.int32)
    got = P.evaluate_adversary(probe, torch.from_numpy(feats), labels, 4)
    want = JP.evaluate_adversary(jprobe, jnp.asarray(feats),
                                 jnp.asarray(labels), 4)
    assert got.accuracy == pytest.approx(want.accuracy, abs=1e-12)
    for a, b in ((got.conditional_entropy_bits,
                  want.conditional_entropy_bits), (got.loss, want.loss)):
        assert abs(a - b) <= 1e-5 * (1 + abs(b))


def test_attack_determinism_under_fixed_generator():
    kw = dict(seed=3, strength=0.0, n_clients=8, batch=12, steps=40,
              device=CPU)
    assert P.attribute_point(gen(7), **kw) == P.attribute_point(gen(7), **kw)
    mkw = dict(seed=3, strength=0.0, n_members=2, n_shadow=4, n_holdout=3,
               batch=8, steps=40, device=CPU)
    c, d = P.membership_point(gen(7), **mkw), P.membership_point(gen(7),
                                                                 **mkw)
    assert c == d and c.attack == "membership"
    assert (c.n_train, c.n_test, c.n_classes) == (6 * 8, 5 * 8, 2)


def test_membership_teeth_on_the_references_weights():
    """The leaky membership row's teeth come from the codec's weights: on
    the reference's draw, which the port's ``make_codec`` makes since
    ``repro_torch.prng`` (``tests/test_torch_prng.py``), the port's
    membership attack at run_sweep's full size scores above 0.2 at every
    generator seed 0-7."""
    kw = dict(seed=0, strength=0.0, n_members=4, n_shadow=12, n_holdout=8,
              batch=24, steps=150, device=CPU)
    for g in range(8):
        rep = P.membership_point(gen(g), **kw)
        assert rep.advantage > 0.2, (g, rep)


def test_uninformed_probe_can_read_below_minus_0_2_in_the_reference():
    """Why chip_smoke holds the privatized knob rows one-sided: advantage
    is accuracy less the held-out split's majority rate, so a probe that
    learned nothing can read below -0.2. The reference's own privatized
    K 64 point at the sweep's size does, at ``PRNGKey(7)``."""
    rep = JSW.attribute_point(jax.random.PRNGKey(7), seed=0, K=64,
                              strength=1.0, n_clients=8, batch=40, steps=150)
    assert rep.advantage < -0.2 and rep.accuracy < rep.chance, rep


def test_attack_emits_scalar_event(tmp_path):
    tap = P.PayloadTap(allow=True)
    tap.capture(payload(40, fill=3), style=0)
    tap.capture(payload(40, fill=9), style=1)
    with obs.recording(tmp_path / "t.jsonl"):
        rep = P.attribute_inference(gen(0), tap, attribute="style",
                                    n_classes=2, n_atoms=16, steps=10)
    assert (rep.n_train, rep.n_test) == (64, 16)
    events = report.load_events(str(tmp_path / "t.jsonl"))
    att = [e for e in events if e["kind"] == "attack"]
    assert len(att) == 1 and att[0]["attack"] == "attribute:style"
    for v in att[0].values():
        assert isinstance(v, (int, float, bool, str, type(None)))


def test_quick_sweep_rows():
    rows = P.run_sweep(gen(0), quick=True, device=CPU)
    names = [r["name"] for r in rows]
    assert names == [
        "harness_matches_wire", "leaky_control_advantage",
        "privatized_advantage",
        *(f"attr_advantage/disent_s{s:.2f}" for s in (0.0, 0.5, 1.0)),
        *(f"attr_advantage/K{K}_{t}" for K in (16, 64)
          for t in ("leaky", "priv")),
        *(f"attr_advantage/gsvq_g{g}s{s}_{t}" for g, s in ((2, 1), (4, 2))
          for t in ("leaky", "priv")),
        "membership_leaky_advantage", "membership_privatized_advantage",
        "oblivious_parity_bitexact", "oblivious_touch_ratio",
        "oblivious_get_overhead"]
    val = {r["name"]: r["value"] for r in rows}
    assert val["harness_matches_wire"] == 1.0
    assert val["oblivious_parity_bitexact"] == 1.0
    assert val["oblivious_touch_ratio"] == 4.0
    assert val["leaky_control_advantage"] > 0.2
    assert abs(val["privatized_advantage"]) < 0.2


def test_full_sweep_rows_are_the_references(monkeypatch):
    """run_sweep(quick=False)'s row names and knobs are those of the
    reference's ``BENCH_privacy.json``; the attacks are stubbed, every
    capture and the oblivious row run."""
    import json
    import pathlib
    stub = P.AttackReport("stub", 0.5, 0.25, 0.25, 1.0, 1, 1, 4)
    monkeypatch.setattr(SW, "attribute_inference", lambda *a, **k: stub)
    monkeypatch.setattr(SW, "membership_inference", lambda *a, **k: stub)
    rows = P.run_sweep(gen(0), quick=False, device=CPU)
    bench = json.loads((pathlib.Path(__file__).parents[1]
                        / "BENCH_privacy.json").read_text())
    want = [r for r in bench["rows"] if not r["name"].startswith("_")]
    assert [r["name"] for r in rows] == [r["name"] for r in want]
    for r, w in zip(rows, want):
        knobs = dict(kv.split("=") for kv in w["extra"].split())
        for k in ("knob", "K", "n_groups", "n_slices", "strength",
                  "apply_in", "captured_bytes", "n_members", "ops"):
            if k in knobs and k in r["extra"]:
                assert str(r["extra"][k]) == knobs[k], (r["name"], k)
    val = {r["name"]: r["value"] for r in rows}
    assert val["oblivious_touch_ratio"] == 4.0
    assert val["harness_matches_wire"] == 1.0


def test_sweep_captures_are_the_populations_it_attacked(monkeypatch):
    """run_sweep(captures=) keeps, under each facade and knob row's name,
    the tap its attack saw, the codec and the batches encoded: the
    reference's population draws, whose harness codes at the capture's
    strength are the tap's words."""
    stub = P.AttackReport("stub", 0.5, 0.25, 0.25, 1.0, 1, 1, 4)
    seen = []
    monkeypatch.setattr(SW, "attribute_inference",
                        lambda g, tap, **k: seen.append(tap) or stub)
    monkeypatch.setattr(SW, "membership_inference", lambda *a, **k: stub)
    caps = {}
    rows = P.run_sweep(gen(0), quick=True, device=CPU, captures=caps)
    knobs = ("facade", "disentanglement_strength", "codebook_size",
             "gsvq_grouping")
    assert list(caps) == [r["name"] for r in rows
                          if r["extra"].get("knob") in knobs]
    assert all(c.tap is t for c, t in zip(caps.values(), seen))
    rng = np.random.default_rng(17)
    protos = rng.normal(size=(SW.N_CONTENT, SW.T_SEQ, SW.D_MODEL))
    shifts = rng.normal(size=(SW.N_STYLES, SW.D_MODEL)) * SW.SHIFT_SCALE
    want = [JSW.client_batch(rng, protos, shifts[c % 4], 24)[0]
            for c in range(8)]
    for name, cap in caps.items():
        assert len(cap.inputs) == len(cap.tap) == 8, name
        for x, w, rec in zip(cap.inputs, want, cap.tap.records):
            np.testing.assert_array_equal(x, w)
            harness = SW.encode_partial(cap.params, cap.cfg, x, cap.strength)
            assert torch.equal(rec.payload.payload, harness.payload), name
    assert caps["leaky_control_advantage"].strength == 0.0
    assert caps["privatized_advantage"].strength == 1.0


# ------------------------------------------------------------- the driver

def test_redteam_driver_matches_reference_example(monkeypatch):
    """The driver's tour: the reference scheduler's participants, and every
    tapped uplink's words equal to the reference wire's on the driver's own
    weights; the example's three checks hold."""
    monkeypatch.setenv(P.REDTEAM_ENV_VAR, "1")
    out = R.run(device=CPU)
    sched = JScheduler(R.N_SLOTS, J_SCENARIOS["adversary"].sched,
                       key=jax.random.PRNGKey(R.SCHED_KEY))
    want = [sched.step().participants.tolist() for _ in range(R.ROUNDS)]
    assert out["participants"] == want
    assert len(out["tap"]) == sum(map(len, want))
    for apply_in, tap in ((True, out["tap"]), (False, out["tap_leaky"])):
        cfg, params, _ = SW.make_codec(0, K=R.K, apply_in=apply_in,
                                       device=CPU)
        jcfg, _, _ = JSW.make_codec(0, K=R.K, apply_in=apply_in)
        jparams = {"encoder": {"proj": None}, "decoder": {"proj": None}}
        for k, v in params_to_numpy(params).items():
            if k == "codebook":
                jparams[k] = jnp.asarray(v)
            else:
                jparams[k.split("/")[0]]["proj"] = jnp.asarray(v)
        jsrv = JServer(JState(params=jparams, opt=j_adamw_init(jparams),
                              step=jnp.zeros((), jnp.int32)), jcfg)
        rng = np.random.default_rng(0)
        protos = rng.normal(size=(SW.N_CONTENT, SW.T_SEQ, SW.D_MODEL))
        shifts = rng.normal(size=(SW.N_STYLES, SW.D_MODEL)) * SW.SHIFT_SCALE
        recs = iter(tap.records)
        for part in want:
            for c in part:
                x, _ = JSW.client_batch(rng, protos, shifts[c % 4], R.BATCH)
                jp = jsrv.deploy(client_id=c).transmit(x)
                r = next(recs)
                assert r.meta == {"client": c, "style": c % 4}
                np.testing.assert_array_equal(
                    r.payload.payload.numpy().view(np.uint32),
                    np.asarray(jp.payload))
    assert out["leaky"].advantage > 0.2
    assert abs(out["privatized"].advantage) < 0.2
    assert out["oblivious"]["parity_bitexact"] == 1.0


def test_core_privacy_is_a_tombstone():
    from repro_torch.core import privacy as old
    for name in ("privacy_audit", "train_adversary", "AdversaryMetrics"):
        with pytest.raises(ImportError,
                           match=f"repro_torch.privacy.{name}"):
            getattr(old, name)
    with pytest.raises(AttributeError):
        old.never_existed
    assert sorted(P.__all__) == sorted(JP.__all__)
    for name in P.__all__:
        assert hasattr(P, name)
