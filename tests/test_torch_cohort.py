"""The port's cohort engine (``repro_torch.sim.cohort``) and the encode's
independence of its stack, on the CPU.

* ``CohortPlan.build`` / ``from_groups`` equal the reference's plans on the
  same members.
* Grouping and order invariance, bit-exact with no tolerance: any partition
  of the same clients, singletons included, in any order, gives the same
  int64 ``MergeStats``, the same merged codebook, Σ cohort ``nbytes`` equal
  to the population round's, and cohort payloads whose concatenation is the
  population payload word for word and whose features are the population's.
* The encode's plain version: record r of an R-stack is the same words,
  counts and sums as record r encoded alone, for VQ and GSVQ; the CUDA
  wrapper's statistics partials depend on a record's shape alone.
* Neither the port nor ``chip_smoke.py`` imports jax or the reference.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint.npz import save_pytree  # noqa: E402
from repro.core import octopus as JOC  # noqa: E402
from repro.core.dvqae import DVQAEConfig as JConfig  # noqa: E402
from repro.sim import CohortPlan as JPlan  # noqa: E402
from repro_torch.convert import load_npz  # noqa: E402
from repro_torch.core import octopus as OC  # noqa: E402
from repro_torch.core.dvqae import DVQAEConfig  # noqa: E402
from repro_torch.kernels import encode_codes as E  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.pack_bits import code_bits  # noqa: E402
from repro_torch.obs import dispatch_monitor  # noqa: E402
from repro_torch.sim import CohortEngine, CohortPlan  # noqa: E402
from repro_torch.wire.payload import concat_payloads  # noqa: E402
from repro_torch.wire.session import OctopusServer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(kind="image", in_channels=3, hidden=8, latent_dim=8,
            codebook_size=16, n_res_blocks=1)
GSVQ = dict(TINY, n_groups=4, n_slices=2)
N_CLIENTS = 12


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU tensors run far faster on one thread than on many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return torch.from_numpy(np.random.default_rng(1).standard_normal(
        (N_CLIENTS, 2, 8, 8, 3)).astype(np.float32))


def data_fn(data):
    return lambda ids: data[torch.as_tensor(np.array(ids, np.int64))]


def server_for(kw, tmp_path):
    """The port's server from the reference's seed-0 weights."""
    path = str(tmp_path / "params.npz")
    save_pytree(path, JOC.server_init(jax.random.PRNGKey(0),
                                      JConfig(**kw)).params)
    cfg = DVQAEConfig(**kw)
    return OC.ServerState(params=load_npz(path, cfg, device="cpu")), cfg


# ----------------------------------------------------------------- plans

@pytest.mark.parametrize("n,size", [(12, 5), (13, 4), (10, 3), (7, 7),
                                    (1, 4), (9, 1), (512, 64), (513, 128)])
def test_cohort_plan_build_matches_reference(n, size):
    members = np.arange(100, 100 + n)
    got, want = CohortPlan.build(members, size), JPlan.build(members, size)
    assert got.sizes == want.sizes and got.n_cohorts == want.n_cohorts
    for a, b in zip(got.cohorts, want.cohorts):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.members, want.members)
    assert got.n_clients == want.n_clients == n


def test_cohort_plan_from_groups_matches_reference():
    groups = [[3, 1], [0], [2, 4, 5]]
    got, want = CohortPlan.from_groups(groups), JPlan.from_groups(groups)
    assert got.sizes == want.sizes == (2, 1, 3)
    np.testing.assert_array_equal(got.members, want.members)
    for bad in ([], [[1], []]):
        with pytest.raises(ValueError):
            CohortPlan.from_groups(bad)
    with pytest.raises(ValueError):
        CohortPlan.build([], 3)


# ------------------------------------------------------------ invariance

def partitions():
    ids = np.arange(N_CLIENTS)
    return [
        [ids[:5], ids[5:9], ids[9:]],                       # ragged
        [ids[i:i + 1] for i in range(N_CLIENTS)],           # singletons
        [ids[:1], ids[1:3], ids[3:]],                       # 1/2/9
        [ids[8:], ids[4:8], ids[:4]],                       # reversed order
        [ids[::-1][:7], ids[::-1][7:]],                     # reversed members
    ]


@pytest.mark.parametrize("kw", [TINY, GSVQ], ids=["vq", "gsvq"])
def test_cohort_grouping_and_order_invariance_bitexact(kw, data, tmp_path):
    server, cfg = server_for(kw, tmp_path)
    engine = CohortEngine(cfg, gamma=0.9, n_local_steps=0)
    full = engine.round(server, CohortPlan.build(np.arange(N_CLIENTS),
                                                 N_CLIENTS), data_fn(data))
    assert len(full.payloads) == 1
    pop = full.payloads[0]
    merged_full = OC.server_merge_stats(server, full.stats)
    feats_full = OC.codes_to_features(cfg, pop, server.params["codebook"])
    for groups in partitions():
        plan = CohortPlan.from_groups(groups)
        with dispatch_monitor() as counts:
            out = engine.round(server, plan, data_fn(data))
        # one fused encode a cohort, one encoder pass a client
        assert counts.encode_dispatches == plan.n_cohorts
        assert counts.encoder_passes == N_CLIENTS
        assert torch.equal(out.stats.num, full.stats.num)
        assert torch.equal(out.stats.den, full.stats.den)
        merged = OC.server_merge_stats(server, out.stats)
        assert torch.equal(merged.params["codebook"],
                           merged_full.params["codebook"])
        assert out.nbytes == full.nbytes == pop.nbytes
        assert sum(p.n_records for p in out.payloads) == N_CLIENTS
        if np.array_equal(plan.members, np.arange(N_CLIENTS)):
            cat = concat_payloads(out.payloads)
            assert cat.shape == pop.shape and cat.nbytes == pop.nbytes
            assert torch.equal(cat.payload, pop.payload)
            assert cat.checksum == pop.checksum
            feats = OC.codes_to_features(cfg, cat,
                                         server.params["codebook"])
            assert torch.equal(feats, feats_full)
        else:                    # each client's record, wherever it rode
            rows = pop.payload.shape[0] // N_CLIENTS
            for ids, p in zip(plan.cohorts, out.payloads):
                for j, c in enumerate(ids):
                    assert torch.equal(
                        p.payload[j * rows:(j + 1) * rows],
                        pop.payload[c * rows:(c + 1) * rows])


def test_cohort_payloads_ingest_and_decode_like_population(data, tmp_path):
    server, cfg = server_for(TINY, tmp_path)
    engine = CohortEngine(cfg, gamma=0.9, n_local_steps=0)
    ids = np.arange(N_CLIENTS)
    y = torch.arange(N_CLIENTS * 2).reshape(N_CLIENTS, 2)
    labels_fn = data_fn(y)
    pop = engine.round(server, CohortPlan.from_groups([ids]), data_fn(data),
                       labels_fn=labels_fn)
    out = engine.round(server, CohortPlan.build(ids, 5), data_fn(data),
                       labels_fn=labels_fn)
    a = OctopusServer(server, cfg, device="cpu")
    b = OctopusServer(server, cfg, device="cpu")
    for p in pop.payloads:
        assert a.ingest(p, client_ids=ids).verdict == "accepted"
    for c, p in zip(CohortPlan.build(ids, 5).cohorts, out.payloads):
        assert b.ingest(p, client_ids=c).verdict == "accepted"
    fa, la = a.features()
    fb, lb = b.features()
    assert torch.equal(fa, fb)
    assert torch.equal(la["label"], lb["label"])
    assert a.store.total_bytes == b.store.total_bytes == pop.nbytes
    codes, version = b.store.get(7, 0)
    assert version == 0
    assert torch.equal(codes, pop.payloads[0].unpack()[7])


def test_cohort_round_fine_tuning_clients_is_grouping_invariant(data,
                                                                tmp_path):
    """With n_local_steps = 1 every client fine-tunes its own copy: still
    the same totals under any grouping."""
    server, cfg = server_for(TINY, tmp_path)
    engine = CohortEngine(cfg, gamma=0.9, n_local_steps=1)
    ids = np.arange(6)
    one = engine.round(server, CohortPlan.from_groups([ids]), data_fn(data))
    two = engine.round(server, CohortPlan.from_groups([ids[3:], ids[:1],
                                                       ids[1:3]]),
                       data_fn(data))
    assert torch.equal(one.stats.num, two.stats.num)
    assert torch.equal(one.stats.den, two.stats.den)


# ------------------------------------------- the encode's stack independence

@pytest.mark.parametrize("n_groups,n_slices", [(1, 1), (8, 2), (16, 4)])
def test_plain_encode_record_equals_it_alone(n_groups, n_slices):
    """Words, counts and sums of record r in an (R, P, M) stack are the
    bits of record r encoded alone, for every r."""
    R, P, K, M = 9, 301, 64, 16
    rng = np.random.default_rng(n_groups)
    z = torch.from_numpy(rng.standard_normal((R, P, M)).astype(np.float32))
    cb = torch.from_numpy(rng.standard_normal((R, K, M)).astype(np.float32))
    gsvq = n_groups > 1 or n_slices > 1
    bits = code_bits(n_groups if gsvq else K)
    kw = dict(bits=bits, n_groups=n_groups, n_slices=n_slices)
    words, counts, sums = ops.encode_codes(z, cb, **kw)
    rows = words.shape[0] // R
    for r in range(R):
        w1, c1, s1 = ops.encode_codes(z[r:r + 1], cb[r:r + 1], **kw)
        assert torch.equal(words[r * rows:(r + 1) * rows], w1)
        assert torch.equal(counts[r:r + 1], c1)
        assert torch.equal(sums[r:r + 1], s1)
    for sub in (slice(2, 5), slice(0, 1), slice(4, 9)):
        w, c, s = ref.encode_codes_ref(z[sub], cb[sub], **kw)
        assert torch.equal(w, words[sub.start * rows:sub.stop * rows])
        assert torch.equal(s, sums[sub])


@pytest.mark.parametrize("P,want", [(1, 1), (127, 1), (129, 2),
                                    (2048, 16), (4096, 32), (10240, 32),
                                    (16384, 32), (32768, 64), (65536, 128),
                                    (10 ** 6, 128)])
def test_resident_partials_follow_the_record_shape(P, want):
    """The resident kernel's blocks a record: one per 512 rows, at least 32
    and at most 128, never more than its 128-row tiles, whatever R."""
    assert E.resident_partials(P) == want
    assert E.resident_partials(P) <= -(-P // E.TILE_ROWS)


@pytest.mark.parametrize("P,S,want", [(1, 2, 1), (33, 2, 2), (7680, 2, 128),
                                      (65536, 2, 128), (100, 1, 2)])
def test_gsvq_partials_follow_the_record_shape(P, S, want):
    assert E.gsvq_partials(P, S) == want


def test_chip_smoke_imports_neither_jax_nor_reference():
    """chip_smoke.py, like every module of the port, never imports jax or
    the reference package."""
    text = (ROOT / "chip_smoke.py").read_text()
    imports = re.findall(r"^\s*(?:from|import)\s+([\w.]+)", text, re.M)
    bad = sorted({m for m in imports
                  if m.split(".")[0] in ("jax", "jaxlib", "repro")})
    assert not bad, bad
    assert "repro_torch" in {m.split(".")[0] for m in imports}
