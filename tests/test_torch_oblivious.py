"""Port parity of the oblivious code store (``repro_torch.privacy
.oblivious``): on the same op streams as ``repro.privacy.ObliviousCodeStore``
(the reference's ``tests/test_privacy_redteam.py`` streams, FIFO and
reservoir), the access log, ``overhead()`` and every ``get`` are the
reference's bit for bit, and every answer is the plain sharded store's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import privacy as JP  # noqa: E402
from repro.core.dvqae import DVQAEConfig as JConfig  # noqa: E402
from repro.privacy import sweep as JSW  # noqa: E402
from repro.wire.payload import CodePayload as JPayload  # noqa: E402
import repro_torch.privacy as P  # noqa: E402
from repro_torch.core.dvqae import DVQAEConfig  # noqa: E402
from repro_torch.kernels.pack_bits import code_bits, packing_dims  # noqa: E402
from repro_torch.privacy import sweep as SW  # noqa: E402
from repro_torch.server import ShardedCodeStore  # noqa: E402
from repro_torch.wire.payload import CodePayload  # noqa: E402

torch.set_num_threads(1)

BITS = code_bits(16)
TINY = dict(kind="image", in_channels=3, hidden=8, latent_dim=8,
            codebook_size=16, n_res_blocks=1)


def words(n_samples, fill):
    """Words of a 1-client (1, n_samples, 3) payload: codes ``fill + i``."""
    G, W = packing_dims(BITS)
    rows = (n_samples * 3 + G - 1) // G
    return ((fill + np.arange(rows * W)) % 0x7FFFFFFF).astype(
        np.uint32).reshape(rows, W)


def payloads(n_samples, version, fill):
    w = words(n_samples, fill)
    kw = dict(bits=BITS, shape=(1, n_samples, 3), version=version)
    return (CodePayload.from_words(torch.from_numpy(w.view(np.int32)), **kw),
            JPayload.from_words(w, **kw))


def stores(policy="fifo", capacity=8, n_shards=3, oblivious_seed=11):
    kw = dict(n_shards=n_shards, seed=5, policy=policy,
              capacity_samples=capacity)
    return (ShardedCodeStore(DVQAEConfig(**TINY), **kw),
            P.ObliviousCodeStore(DVQAEConfig(**TINY), **kw,
                                 oblivious_seed=oblivious_seed),
            JP.ObliviousCodeStore(JConfig(**TINY), **kw,
                                  oblivious_seed=oblivious_seed))


def run_stream(policy, stream):
    """Feed one (n, version, client) stream into the plain store, the
    port's oblivious store and the reference's; hold them equal after every
    op and on every get."""
    plain, obl, jobl = stores(policy)
    for i, (n, version, client) in enumerate(stream):
        p, jp = payloads(n, version, i)
        plain.add(p, client_ids=[client], round=i)
        rec = obl.add(p, client_ids=[client], round=i)
        jrec = jobl.add(jp, client_ids=[client], round=i)
        assert (rec.round, rec.version) == (jrec.round, jrec.version)
        ing = obl.ingested_bytes_by_version
        ev, st = obl.evicted_bytes_by_version, obl.stored_bytes_by_version
        for v in ing:      # stored + evicted == ingested, always
            assert st.get(v, 0) + ev.get(v, 0) == ing[v]
        assert obl.access_log == jobl.access_log
    assert obl.overhead() == jobl.overhead()
    assert len(plain) == len(obl) == len(jobl)
    assert plain.total_bytes == obl.total_bytes == jobl.total_bytes
    np.testing.assert_array_equal(obl.codes().numpy(),
                                  np.asarray(jobl.codes()))
    assert torch.equal(plain.codes(), obl.codes())
    for i, (_, _, client) in enumerate(stream):
        try:
            ia, va = plain.get(client, i)
        except KeyError:
            with pytest.raises(KeyError):
                obl.get(client, i)
            with pytest.raises(KeyError):
                jobl.get(client, i)
            continue
        ib, vb = obl.get(client, i)
        jb, jvb = jobl.get(client, i)
        assert va == vb == jvb
        assert torch.equal(ia, ib)
        np.testing.assert_array_equal(ib.numpy(), np.asarray(jb))
    assert obl.access_log == jobl.access_log
    assert obl.overhead() == jobl.overhead()
    return obl


FIXED_STREAMS = [
    [(2, 0, 0), (3, 0, 1), (2, 1, 0), (4, 0, 2), (1, 1, 3), (2, 0, 0)],
    [(4, 0, 0)] * 8,                        # one partition, heavy churn
    [(1, v, c) for v in (0, 1, 2) for c in range(6)],
]


@pytest.mark.parametrize("policy", ["fifo", "reservoir"])
@pytest.mark.parametrize("stream", FIXED_STREAMS)
def test_oblivious_matches_reference_fixed(policy, stream):
    run_stream(policy, stream)


@pytest.mark.parametrize("seed", range(4))
def test_oblivious_matches_reference_drawn(seed):
    rng = np.random.default_rng(seed)
    stream = [tuple(int(v) for v in (rng.integers(1, 5), rng.integers(0, 3),
                                     rng.integers(0, 8)))
              for _ in range(int(rng.integers(1, 26)))]
    run_stream(("fifo", "reservoir")[seed % 2], stream)


def test_oblivious_schedule_is_query_independent():
    """Same oblivious seed and grid -> identical touch schedules under
    different query streams; every schedule touches every live partition
    exactly once."""
    _, a, _ = stores()
    _, b, _ = stores()
    for i in range(6):
        a.add(payloads(2, i % 2, i)[0], client_ids=[i], round=i)
        b.add(payloads(2, i % 2, i + 40)[0], client_ids=[5 - i], round=i)
    for i in range(6):
        a.get(i, i)
        b.get(5 - i, i)
    assert len(a.access_log) == len(b.access_log) == 12
    for (op_a, sched_a), (op_b, sched_b) in zip(a.access_log, b.access_log):
        assert op_a == op_b and sched_a == sched_b
        assert sorted(sched_a) == sorted(set(sched_a))
    oh = a.overhead()
    assert oh["touched_partitions"] > oh["useful_partitions"]
    assert oh["partition_touch_ratio"] > 1.0


def test_oblivious_open_version_pre_creates_grid():
    obl = P.ObliviousCodeStore(DVQAEConfig(**TINY), n_shards=4,
                               oblivious_seed=2)
    obl.open_version(3)
    assert sorted(obl.partitions) == [(3, s) for s in range(4)]
    obl.add(payloads(2, 3, 0)[0], client_ids=[1], round=0)
    op, sched = obl.access_log[-1]
    assert op == "add" and sorted(sched) == [(3, s) for s in range(4)]
    with pytest.raises(KeyError):
        obl.get(7, 0)


def test_oblivious_point_matches_reference_counters():
    """The sweep's oblivious row on the CPU: parity, and every counter but
    the wall ratio equal to the reference's (they follow from the shapes
    and the schedule alone)."""
    got = SW.oblivious_point(seed=0, batch=8, device="cpu")
    want = JSW.oblivious_point(seed=0, batch=8)
    assert got["parity_bitexact"] == 1.0
    assert got["get_wall_ratio"] > 0
    for k in want:
        if k != "get_wall_ratio":
            assert got[k] == want[k], k
