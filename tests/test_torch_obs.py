"""The port's flight recorder and metrics plane (``repro_torch.obs``).

Mirrors ``tests/test_obs.py`` for the port, at its ``tiny_cfg`` widths:
tracing is bit-neutral (a session round and a cohort round give the same
words, statistics and features with a recorder installed), the dispatch
monitor counts the port's encoder passes and fused dispatches and restores
the originals, events carry payload METADATA only and refuse tensors,
arrays and containers (§2.5), the store keeps its gauges and per-version
decode histogram, and ``report --check`` holds the §2.8 byte ledger.

Interop: the JSONL schema is the reference's, so the reference's
``repro.obs.report`` checks a trace the port wrote, and summarises it to
the same event counts and uplink bytes as the reference's own trace of the
same protocol on the same numpy inputs.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.checkpoint.npz import save_pytree  # noqa: E402
from repro.core import octopus as JOC  # noqa: E402
from repro.core.dvqae import DVQAEConfig as JConfig  # noqa: E402
from repro.obs import report as jreport  # noqa: E402
from repro.wire.session import OctopusServer as JServer  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.convert import load_npz  # noqa: E402
from repro_torch.core import ema  # noqa: E402
from repro_torch.core import octopus as OC  # noqa: E402
from repro_torch.core.dvqae import DVQAEConfig  # noqa: E402
from repro_torch.obs import report as obs_report  # noqa: E402
from repro_torch.sim import CohortEngine, CohortPlan  # noqa: E402
from repro_torch.wire.session import OctopusServer  # noqa: E402

TINY = dict(kind="image", in_channels=3, hidden=8, latent_dim=8,
            codebook_size=16, n_res_blocks=1)
N_CLIENTS = 12


@pytest.fixture(autouse=True)
def no_ambient_recorder():
    """Tests own the recorder lifecycle: drop any env-installed one."""
    obs.uninstall()
    jobs.uninstall()
    yield
    obs.uninstall()
    jobs.uninstall()


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU tensors run far faster on one thread than on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The reference's seed-0 weights, saved for both packages."""
    jcfg = JConfig(**TINY)
    path = str(tmp_path_factory.mktemp("obs") / "params.npz")
    jstate = JOC.server_init(jax.random.PRNGKey(0), jcfg)
    save_pytree(path, jstate.params)
    return path, jstate, jcfg, DVQAEConfig(**TINY)


@pytest.fixture(scope="module")
def data():
    return np.random.default_rng(1).standard_normal(
        (N_CLIENTS, 2, 8, 8, 3)).astype(np.float32)


def state(weights):
    path, _, _, cfg = weights
    return OC.ServerState(params=load_npz(path, cfg, device="cpu"))


def server(weights):
    return OctopusServer(state(weights), weights[3], device="cpu")


def data_fn(data):
    x = torch.from_numpy(data)
    return lambda ids: x[torch.as_tensor(np.array(ids, np.int64))]


# ------------------------------------------------------------ zero-overhead

def test_recorder_is_off_by_default():
    assert obs.active() is None


def test_recording_scopes_the_singleton(tmp_path):
    path = tmp_path / "t.jsonl"
    with obs.recording(path) as rec:
        assert obs.active() is rec
        rec.event("merge", version=1)
        with rec.span("decode", version=0):
            pass
    assert obs.active() is None
    events = obs_report.load_events(str(path))
    assert [e["kind"] for e in events] == ["merge", "decode"]
    assert events[1]["dur_ms"] >= 0.0
    assert [e["seq"] for e in events] == [0, 1]


def test_install_from_env(tmp_path, monkeypatch):
    path = tmp_path / "env.jsonl"
    monkeypatch.setenv(obs.ENV_VAR, str(path))
    rec = obs.install_from_env()
    try:
        assert obs.active() is rec and rec.path == str(path)
        assert obs.install_from_env() is rec      # idempotent
    finally:
        obs.uninstall()
        rec.close()
    assert obs.ENV_VAR == jobs.ENV_VAR == "OCTOPUS_TRACE"
    assert obs.EVENT_KINDS == jobs.EVENT_KINDS
    assert obs.PAYLOAD_META_FIELDS == jobs.PAYLOAD_META_FIELDS


# ------------------------------------------------------- tracing neutrality

def test_session_round_bit_identical_with_tracing(weights, data, tmp_path):
    srv = server(weights)
    plain_client = srv.deploy()
    plain = plain_client.round(data[0])
    with obs.recording(tmp_path / "t.jsonl") as rec:
        traced_client = srv.deploy()
        traced = traced_client.round(data[0])
    assert torch.equal(plain.payload, traced.payload)
    assert (plain.nbytes, plain.shape, plain.checksum) == (
        traced.nbytes, traced.shape, traced.checksum)
    for a, b in zip(plain_client.state.ema, traced_client.state.ema):
        assert torch.equal(a, b)
    kinds = [e["kind"] for e in obs_report.load_events(str(tmp_path /
                                                            "t.jsonl"))]
    assert kinds == ["encode", "uplink"] and rec.n_events == 2


def test_cohort_round_bit_identical_with_tracing(weights, data, tmp_path):
    """Streamed round words, statistics and features are unchanged by
    tracing; one encode event per cohort, metadata matching the
    payloads."""
    srv_state, cfg = state(weights), weights[3]
    engine = CohortEngine(cfg, gamma=0.9, n_local_steps=0)
    plan = CohortPlan.build(np.arange(N_CLIENTS), 5)
    plain = engine.round(srv_state, plan, data_fn(data))
    with obs.recording(tmp_path / "t.jsonl") as rec:
        traced = engine.round(srv_state, plan, data_fn(data), round_idx=3)
    assert torch.equal(plain.stats.num, traced.stats.num)
    assert torch.equal(plain.stats.den, traced.stats.den)
    for a, b in zip(plain.payloads, traced.payloads):
        assert torch.equal(a.payload, b.payload)
    cb = srv_state.params["codebook"]
    assert torch.equal(OC.codes_to_features(cfg, plain.payloads[0], cb),
                       OC.codes_to_features(cfg, traced.payloads[0], cb))
    events = obs_report.load_events(str(tmp_path / "t.jsonl"))
    enc = [e for e in events if e["kind"] == "encode"]
    assert len(enc) == plan.n_cohorts == rec.n_events
    assert [e["nbytes"] for e in enc] == [p.nbytes for p in traced.payloads]
    assert [e["cohort_size"] for e in enc] == list(plan.sizes)
    assert all(e["round"] == 3 for e in enc)


# ------------------------------------------------------- dispatch monitor

def test_dispatch_monitor_counts_a_round(weights, data, tmp_path):
    """One facade round = ONE encoder pass and ONE fused encode dispatch,
    with tracing on and off; non-zero counts fold into the recorder."""
    srv = server(weights)
    with obs.dispatch_monitor() as plain:
        srv.deploy().round(data[0], finetune=0)
    with obs.recording(tmp_path / "t.jsonl") as rec:
        with obs.dispatch_monitor() as traced:
            srv.deploy().round(data[0], finetune=0)
    for counts in (plain, traced):
        assert (counts.encoder_passes, counts.encode_dispatches) == (1, 1)
        assert counts.pack_dispatches == 0      # packed inside the encode
    snap = rec.metrics.snapshot()["counters"]
    assert snap["encoder_passes"] == 1 and snap["encode_dispatches"] == 1


def test_dispatch_monitor_counts_decode_and_pack(weights, data):
    from repro_torch.kernels import ops
    idx = torch.arange(16, dtype=torch.int32) % 4
    srv = server(weights)
    p = srv.deploy().transmit(data[0])
    with obs.dispatch_monitor() as counts:
        words = ops.pack_codes(idx, bits=2)
        ops.unpack_codes(words, bits=2, count=16)
        srv.decode(p)
        srv.ingest(p)
        srv.features()
    assert counts.pack_dispatches == 1
    assert counts.unpack_dispatches == 1
    assert counts.decode_dispatches == 2
    assert counts.encoder_passes == counts.encode_dispatches == 0


def test_dispatch_monitor_restores_originals():
    from repro_torch.core import dvqae
    from repro_torch.kernels import ops
    before = (dvqae.encode, ops.encode_codes, ops.decode_codes,
              ops.pack_codes, ops.unpack_codes)
    with pytest.raises(RuntimeError):
        with obs.dispatch_monitor():
            assert ops.encode_codes is not before[1]
            raise RuntimeError("boom")
    assert (dvqae.encode, ops.encode_codes, ops.decode_codes,
            ops.pack_codes, ops.unpack_codes) == before


# -------------------------------------------------------- §2.5 in the trace

def test_trace_never_carries_words_or_labels(weights, data, tmp_path):
    srv = server(weights)
    labels = {"content": np.arange(2, dtype=np.int32)}
    with obs.recording(tmp_path / "t.jsonl") as rec:
        p = srv.deploy().round(data[0], labels=labels)
        srv.ingest(p)
        srv.features()
        srv.decode(p)
        for kind in obs.EVENT_KINDS:
            rec.event(kind, **obs.payload_meta(p))
    seen = set()
    for ev in obs_report.load_events(str(tmp_path / "t.jsonl")):
        seen.add(ev["kind"])
        assert "payload" not in ev and "words" not in ev
        assert "labels" not in ev and "content" not in ev
        for v in ev.values():
            assert isinstance(v, (int, float, bool, str, type(None)))
    assert seen >= set(obs.EVENT_KINDS)
    meta = obs.payload_meta(p)
    assert set(meta) == set(obs.PAYLOAD_META_FIELDS)
    assert all(type(meta[k]) is int for k in meta if k != "privatized")
    assert meta["nbytes"] == p.nbytes and meta["privatized"] is True


def test_event_refuses_tensors_arrays_and_containers(tmp_path):
    with obs.recording(tmp_path / "t.jsonl") as rec:
        for kind in obs.EVENT_KINDS:
            for bad in (np.arange(4), torch.arange(4), torch.tensor(3.0),
                        torch.zeros((2, 2), dtype=torch.int32), [1, 2],
                        (1, 2), {"y": 1}, b"words"):
                with pytest.raises(ValueError, match="scalar-only"):
                    rec.event(kind, leak=bad)
        ok = rec.event("tap", n=3, f=1.5, s="x", b=True, none=None,
                       np_scalar=np.float32(2.0))
        assert ok["n"] == 3
    events = obs_report.load_events(str(tmp_path / "t.jsonl"))
    assert [e["kind"] for e in events] == ["tap"]   # refused != written
    assert events[0]["np_scalar"] == 2.0


# ----------------------------------------------------------- metrics plane

def test_metrics_registry_instruments():
    m = obs.MetricsRegistry()
    m.inc("uplinks", 3)
    m.inc("uplinks")
    m.set_gauge("depth", 7)
    for v in (2.0, 4.0, 6.0):
        m.observe("ms", v)
    snap = m.snapshot()
    assert snap["counters"]["uplinks"] == 4
    assert snap["gauges"]["depth"] == 7
    h = snap["histograms"]["ms"]
    assert (h["count"], h["min"], h["max"], h["mean"]) == (3, 2.0, 6.0, 4.0)


def test_store_gauges_and_decode_histogram(weights, data, tmp_path):
    srv = server(weights)
    with obs.recording(tmp_path / "t.jsonl") as rec:
        p = srv.deploy().round(data[0])
        q = srv.deploy().transmit(data[1])
        srv.ingest(p)
        srv.ingest(q)
        bad = q._replace(checksum=(q.checksum or 0) ^ 1)
        assert srv.ingest(bad).verdict == "rejected"
        srv.features()
        srv.merge_stats(ema.merge_stats(srv.state.params["codebook"][None],
                                        torch.ones((1, 16))))
    m = rec.metrics
    assert m.gauge("store_records").value == 2
    assert m.gauge("store_samples").value == 4
    assert m.gauge("store_bytes").value == p.nbytes + q.nbytes
    assert m.counter("uplinks_ingested").value == 2
    assert m.counter("bytes_rejected").value == bad.nbytes
    assert m.counter("merges").value == 1
    h = m.histogram("decode_ms/v0")
    assert h.count == 1 and h.min >= 0.0
    events = obs_report.load_events(str(tmp_path / "t.jsonl"))
    dec = [e for e in events if e["kind"] == "decode"]
    assert len(dec) == 1 and dec[0]["n_records"] == 2
    assert dec[0]["n_samples"] == 4 and dec[0]["version"] == 0
    assert [e["source"] for e in events if e["kind"] == "merge"] == ["stats"]


# ----------------------------------------------------------- report CLI

def traced_protocol(srv, data, trace, *, ingest):
    """Two client rounds, their uplinks sent (an ``uplink`` event tagged
    with the round, as a traffic loop's queue logs it) and ingested, a
    features() decode and the round's ledger event, traced to ``trace``;
    the reference's and the port's session facades both run it."""
    rec_mod = obs if isinstance(srv, OctopusServer) else jobs
    with rec_mod.recording(trace) as rec:
        sent = 0
        for i in range(2):
            p = srv.deploy(client_id=i).round(ingest(data[i]), finetune=0)
            rec.uplink(p, round=0)
            sent += p.nbytes
            srv.ingest(p, client_ids=[i], round=0)
        srv.features()
        rec.event("round", round=0, n_participants=2, bytes_sent=sent,
                  dur_ms=1.0)
    return sent


def test_report_check_and_json(weights, data, tmp_path, capsys):
    srv = server(weights)
    trace = tmp_path / "t.jsonl"
    sent = traced_protocol(srv, data, trace, ingest=lambda x: x)
    out_json = tmp_path / "rep.json"
    assert obs_report.main([str(trace), "--check", "--json",
                            str(out_json)]) == 0
    text = capsys.readouterr().out
    assert "bytes check OK" in text and "uplinks:" in text
    rep = json.loads(out_json.read_text())
    assert rep["section"] == "obs" and rep["bytes_check_ok"] is True
    rows = {r["name"]: r for r in rep["rows"]}
    # each payload is logged by its client's round and by the loop's send
    assert rows["uplink_bytes"]["value"] == 2 * sent
    assert rows["rounds"]["value"] == 1
    assert any(n.startswith("decode_v") for n in rows)


def test_report_check_fails_on_tampered_ledger(tmp_path):
    trace = tmp_path / "bad.jsonl"
    events = [{"kind": "uplink", "round": 0, "nbytes": 8},
              {"kind": "round", "round": 0, "bytes_sent": 12,
               "dur_ms": 1.0}]
    trace.write_text("\n".join(json.dumps(e) for e in events) + "\n")
    summary = obs_report.summarize(obs_report.load_events(str(trace)))
    assert obs_report.check_bytes(summary)
    assert obs_report.main([str(trace), "--check"]) == 1
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert obs_report.main([str(empty), "--check"]) == 1


def test_reference_report_reads_the_port_trace(weights, data, tmp_path):
    """Interop: the reference's ``report --check`` passes on the port's
    trace, and summarises it to the same event counts and uplink bytes as
    the reference's own trace of the same protocol on the same inputs."""
    _, jstate, jcfg, _ = weights
    port_trace, ref_trace = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    traced_protocol(server(weights), data, port_trace, ingest=lambda x: x)
    traced_protocol(JServer(jstate, jcfg), data, ref_trace,
                    ingest=jnp.asarray)
    assert jreport.main([str(port_trace), "--check"]) == 0
    got = jreport.summarize(jreport.load_events(str(port_trace)))
    want = jreport.summarize(jreport.load_events(str(ref_trace)))
    assert got["kinds"] == want["kinds"]
    assert got["uplinks"] == want["uplinks"]
    assert got["ingest"] == want["ingest"]
    assert [r["uplink_bytes"] for r in got["rounds"]] == \
        [r["uplink_bytes"] for r in want["rounds"]]
    assert {v: d["n_samples"] for v, d in got["decode"].items()} == \
        {v: d["n_samples"] for v, d in want["decode"].items()}
    # and the port's report reads the reference's trace the same way
    assert obs_report.summarize(obs_report.load_events(str(ref_trace))) \
        ["uplinks"] == want["uplinks"]
