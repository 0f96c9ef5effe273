"""The port's stores and registry against the reference's
(``repro_torch.server.store``, ``.registry``).

Streams of payloads packed from the same numpy indices go into both
packages' stores:
* FIFO and reservoir eviction pick the same records (the reservoir draws
  on ``np.random.default_rng(seed)`` as the reference's does);
* the per-version ledgers, the ``ShardedCodeStore`` partitions and
  ``shard_of``, and ``retire_version`` agree;
* ``codes``, ``get``, ``label_dict`` and the bulk decode agree bit for bit;
* ``snapshot_state`` from one package loads through the other's
  ``load_state``, both ways, and later adds evict the same records;
* the registry's migration windows, retirements and snapshots behave as
  the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.dvqae import DVQAEConfig as JConfig  # noqa: E402
from repro.server import registry as JR  # noqa: E402
from repro.server import store as JS  # noqa: E402
from repro.wire.payload import CodePayload as JPayload  # noqa: E402
from repro_torch.core.dvqae import DVQAEConfig  # noqa: E402
from repro_torch.server import registry as R  # noqa: E402
from repro_torch.server import store as S  # noqa: E402
from repro_torch.wire.payload import CodePayload  # noqa: E402

TINY = dict(kind="image", in_channels=3, hidden=8, latent_dim=8,
            codebook_size=16, n_res_blocks=1)
BITS = 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def stream(seed=0, n=24, versions=(0, 1, 2)):
    """(codes (C, B, T), version, client_ids, round, labels) a payload."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        C, B = int(rng.integers(1, 4)), int(rng.integers(1, 4))
        codes = rng.integers(0, 16, size=(C, B, 4)).astype(np.int32)
        ids = rng.integers(0, 64, size=C)
        lab = {"content": rng.integers(0, 5, size=C * B),
               "style": rng.integers(0, 3, size=C * B)}
        out.append((codes, int(versions[i % len(versions)]), ids, i, lab))
    return out


def add_both(port, ref, items):
    for codes, v, ids, rnd, lab in items:
        port.add(CodePayload.pack(torch.from_numpy(codes), bits=BITS,
                                  version=v),
                 client_ids=ids, round=rnd,
                 labels={t: torch.from_numpy(y) for t, y in lab.items()})
        ref.add(JPayload.pack(jnp.asarray(codes), bits=BITS, version=v),
                client_ids=ids, round=rnd,
                labels={t: jnp.asarray(y) for t, y in lab.items()})


def prov(store):
    return [(r.round, r.version, tuple(np.asarray(r.client_ids).tolist()),
             r.packed.nbytes) for r in store.records]


def ledgers(store):
    return (store.ingested_bytes_by_version, store.evicted_bytes_by_version,
            store.stored_bytes_by_version, store.evicted_records,
            store.evicted_samples, store.evicted_bytes, len(store),
            store.n_samples, store.total_bytes, store.versions, store.tasks)


def same_state(port, ref):
    assert prov(port) == prov(ref)
    assert ledgers(port) == ledgers(ref)
    np.testing.assert_array_equal(port.codes().numpy(),
                                  np.asarray(ref.codes()))
    got, want = port.label_dict(), ref.label_dict()
    assert sorted(got) == sorted(want)
    for t in got:
        np.testing.assert_array_equal(got[t].numpy(), np.asarray(want[t]))
    for v in port.versions:
        np.testing.assert_array_equal(port.codes(v).numpy(),
                                      np.asarray(ref.codes(v)))


def make(kind, **kw):
    cfg, jcfg = DVQAEConfig(**TINY), JConfig(**TINY)
    if kind == "single":
        return S.CodeStore(cfg, **kw), JS.CodeStore(jcfg, **kw)
    return S.ShardedCodeStore(cfg, **kw), JS.ShardedCodeStore(jcfg, **kw)


@pytest.mark.parametrize("kind", ["single", "sharded"])
@pytest.mark.parametrize("policy,seed", [("fifo", 0), ("reservoir", 0),
                                         ("reservoir", 5)])
def test_eviction_picks_the_reference_records(kind, policy, seed):
    port, ref = make(kind, capacity_samples=9, policy=policy, seed=seed)
    items = stream(seed=seed + 1, n=40)
    for i in range(0, 40, 8):
        add_both(port, ref, items[i:i + 8])
        same_state(port, ref)
    assert port.evicted_records > 0
    for v, n in port.ingested_bytes_by_version.items():
        assert port.stored_bytes_by_version.get(v, 0) \
            + port.evicted_bytes_by_version.get(v, 0) == n


@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_sharded_partitions_shard_of_and_retire(n_shards):
    port, ref = make("sharded", n_shards=n_shards, capacity_samples=20,
                     policy="reservoir", seed=3)
    add_both(port, ref, stream(seed=2, n=30))
    assert sorted(port.partitions) == sorted(ref.partitions)
    for k, part in port.partitions.items():
        assert prov(part) == prov(ref.partitions[k])
    for ids in ([5], [7, 1], np.array([12, 3]), None, []):
        assert port.shard_of(ids) == ref.shard_of(ids)
    custom = S.ShardedCodeStore(DVQAEConfig(**TINY), n_shards=n_shards,
                                shard_fn=lambda ids: len(ids))
    jcustom = JS.ShardedCodeStore(JConfig(**TINY), n_shards=n_shards,
                                  shard_fn=lambda ids: len(ids))
    assert custom.shard_of([4, 5, 6]) == jcustom.shard_of([4, 5, 6])
    gone, jgone = port.retire_version(1), ref.retire_version(1)
    assert [(r.round, r.version) for r in gone] == \
        [(r.round, r.version) for r in jgone]
    same_state(port, ref)
    assert 1 not in port.versions
    assert port.evicted_bytes_by_version[1] == \
        port.ingested_bytes_by_version[1]


def test_single_store_retire_get_and_decode():
    port, ref = make("single")
    add_both(port, ref, stream(seed=4, n=12))
    for rnd, cid in ((0, None), (5, None), (11, None)):
        rec = port.records[rnd]
        cid = int(rec.client_ids[-1])
        got, v = port.get(cid, rnd)
        want, jv = ref.get(cid, rnd)
        assert v == jv
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(KeyError):
        port.get(999, 0)
    cbs = np.random.default_rng(0).standard_normal((3, 16, 8)) \
        .astype(np.float32)
    reg = R.CodebookRegistry(torch.from_numpy(cbs[0]))
    jreg = JR.CodebookRegistry(jnp.asarray(cbs[0]))
    for cb in cbs[1:]:
        reg.register(torch.from_numpy(cb))
        jreg.register(jnp.asarray(cb))
    feats, labels = port.dataset(registry=reg)
    jfeats, jlabels = ref.dataset(None, registry=jreg)
    np.testing.assert_array_equal(feats.numpy(), np.asarray(jfeats))
    for t in labels:
        np.testing.assert_array_equal(labels[t].numpy(),
                                      np.asarray(jlabels[t]))
    f1, _ = port.dataset(registry=reg, version=1)
    np.testing.assert_array_equal(
        f1.numpy(), np.asarray(ref.dataset(None, registry=jreg,
                                           version=1)[0]))
    with pytest.raises(ValueError, match="version 9"):
        port.dataset(registry=reg, version=9)
    port.retire_version(2), ref.retire_version(2)
    same_state(port, ref)
    g = torch.Generator().manual_seed(0)
    xb, yb = next(iter(port.batches(None, 5, generator=g, steps=1,
                                    registry=reg)))
    assert xb.shape[0] == 5 and yb["content"].shape == (5,)


def test_add_validates_as_the_reference_does():
    port, _ = make("single")
    p = CodePayload.pack(torch.zeros((2, 3, 4), dtype=torch.int32),
                         bits=BITS)
    with pytest.raises(ValueError, match="labels"):
        port.add(p, labels=torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="client_ids"):
        port.add(p, client_ids=[1, 2, 3])
    with pytest.raises(ValueError, match="privatized"):
        port.add(p._replace(privatized=False))
    with pytest.raises(ValueError, match="fifo"):
        S.CodeStore(DVQAEConfig(**TINY), policy="lru")
    with pytest.raises(ValueError, match="n_shards"):
        S.ShardedCodeStore(DVQAEConfig(**TINY), n_shards=0)


def jnp_arrays(arrays):
    return {k: np.asarray(v) for k, v in arrays.items()}


@pytest.mark.parametrize("kind", ["single", "sharded"])
def test_snapshots_interoperate_both_ways(kind):
    kw = dict(capacity_samples=12, policy="reservoir", seed=2)
    port, ref = make(kind, **kw)
    items = stream(seed=6, n=30)
    add_both(port, ref, items[:20])
    # port -> reference
    man, arrays = port.snapshot_state()
    assert all(a.dtype == np.uint32 for k, a in arrays.items()
               if k.endswith("words"))
    ref2 = make(kind, **kw)[1].load_state(man, jnp_arrays(arrays))
    same_state(port, ref2)
    # reference -> port
    jman, jarrays = ref.snapshot_state()
    port2 = make(kind, **kw)[0].load_state(jman, jnp_arrays(jarrays),
                                           device="cpu")
    same_state(port2, ref)
    for r, jr in zip(port2.records, ref.records):
        assert r.packed.checksum == jr.packed.checksum
        assert r.packed.verify()
    # the restored reservoir streams evict as the uninterrupted ones do
    add_both(port2, ref2, items[20:])
    add_both(port, ref, items[20:])
    same_state(port2, ref)
    same_state(port, ref2)


def test_registry_migration_windows_match_reference():
    cbs = np.random.default_rng(1).standard_normal((3, 16, 8)) \
        .astype(np.float32)
    reg = R.CodebookRegistry(torch.from_numpy(cbs[0]))
    jreg = JR.CodebookRegistry(jnp.asarray(cbs[0]))
    assert R.MIGRATION_POLICIES == JR.MIGRATION_POLICIES
    with pytest.raises(ValueError, match="no migration"):
        reg.close_migration()
    with pytest.raises(KeyError):
        reg.begin_migration()                 # v-1 -> v0: v-1 is unknown
    for cb in cbs[1:]:
        assert reg.register(torch.from_numpy(cb)) == \
            jreg.register(jnp.asarray(cb))
    win, jwin = reg.begin_migration(), jreg.begin_migration()
    assert tuple(win) == tuple(jwin) == (1, 2, "keep")
    with pytest.raises(ValueError, match="still open"):
        reg.begin_migration()
    assert tuple(reg.close_migration()) == tuple(jreg.close_migration())
    with pytest.raises(ValueError, match="policy"):
        reg.begin_migration(policy="drop")
    with pytest.raises(ValueError, match="both"):
        reg.begin_migration(src=2, dst=2)
    with pytest.raises(ValueError, match="latest"):
        reg.retire(2)
    reg.retire(0), jreg.retire(0)
    assert reg.retired == jreg.retired == (0,)
    assert reg.is_retired(0) and not reg.is_retired(1)
    with pytest.raises(ValueError, match="retired"):
        reg.begin_migration(src=0, dst=2)
    reg.begin_migration(src=1, policy="reencode")
    jreg.begin_migration(src=1, policy="reencode")
    # snapshots interoperate, the open window included
    man, arrays = reg.snapshot_state()
    jman, jarrays = jreg.snapshot_state()
    assert man == jman
    back = JR.CodebookRegistry(jnp.zeros((16, 8))).load_state(man, arrays)
    port = R.CodebookRegistry(torch.zeros(16, 8)).load_state(
        jman, jnp_arrays(jarrays), device="cpu")
    for r in (back, port):
        assert r.latest == 2 and r.retired == (0,)
        assert tuple(r.migration) == (1, 2, "reencode")
        for v in range(3):
            np.testing.assert_array_equal(np.asarray(r.get(v)), cbs[v])
