"""The population-engine driver (``repro_torch.population_engine``) on the
CPU against the reference's ``CohortEngine``.

* Its parity part at a small population: the streamed round equals the
  one-shot round bit for bit in the port (int64 ``MergeStats``, words,
  bytes), and both equal the reference's rounds of the same clients on the
  same weights and pool: payload shapes and bytes exactly, codes under the
  near-tie rule, the merged codebook within ``1e-5*(1 + |x|)`` on the atoms
  no differing code touched.
* The whole driver at a small size: its diurnal traffic equals the
  reference's ``run_traffic`` round for round (participants, cohorts, bytes
  sent and delivered, merged versions), every merge registers a version,
  and every stored payload decodes against its pinned version; one fused
  encode a cohort.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.npz import save_pytree  # noqa: E402
from repro.core import octopus as JOC  # noqa: E402
from repro.core.dvqae import DVQAEConfig as JConfig  # noqa: E402
from repro.server import DiurnalProfile as JDiurnal  # noqa: E402
from repro.server import RoundScheduler as JScheduler  # noqa: E402
from repro.server import SchedulerConfig as JSchedConfig  # noqa: E402
from repro.sim import CohortEngine as JCohort  # noqa: E402
from repro.sim import CohortPlan as JPlan  # noqa: E402
from repro.wire import session as JW  # noqa: E402
from repro_torch import population_engine as P  # noqa: E402
from repro_torch.convert import load_npz  # noqa: E402
from repro_torch.core import octopus as OC  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.obs import dispatch_monitor  # noqa: E402
from repro_torch.sim import CohortEngine  # noqa: E402

TOL = 1e-5                  # of 1 + |x|: merged codebooks across packages
N, COHORT = 48, 8


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    """The example's config in both packages, the reference's seed-0
    weights carried into the port, and a pool drawn with numpy."""
    cfg = P.example_config()
    jcfg = JConfig(kind="image", in_channels=3, hidden=8, latent_dim=8,
                   codebook_size=256, n_res_blocks=1)
    jserver = JOC.server_init(jax.random.PRNGKey(0), jcfg)
    path = str(tmp_path_factory.mktemp("pop") / "params.npz")
    save_pytree(path, jserver.params)
    server = OC.server_init(0, cfg, device="cpu")._replace(
        params=load_npz(path, cfg, device="cpu"))
    pool = np.random.default_rng(5).standard_normal(
        (64, 1, 8, 8, 3)).astype(np.float32)
    return cfg, jcfg, server, jserver, pool


def jdata_fn(pool):
    return lambda ids: jnp.asarray(pool[np.asarray(ids) % len(pool)])


def test_parity_matches_reference_rounds(twins):
    cfg, jcfg, server, jserver, pool = twins
    engine = CohortEngine(cfg, gamma=0.99, n_local_steps=0)
    with dispatch_monitor() as n:
        par = P.parity(engine, server, P.pool_fn(torch.from_numpy(pool)),
                       n=N, cohort=COHORT)
    assert n.encode_dispatches == par["n_cohorts"] == 1 + N // COHORT
    jeng = JCohort(jcfg, gamma=0.99, n_local_steps=0)
    jfull = jeng.round(jserver, JPlan.from_groups([np.arange(N)]),
                       jdata_fn(pool))
    jparts = jeng.round(jserver, JPlan.build(np.arange(N), COHORT),
                        jdata_fn(pool))
    full, parts = par["full"], par["parts"]
    assert parts.nbytes == full.nbytes == jparts.nbytes == jfull.nbytes
    assert [(p.shape, p.n_records, p.nbytes) for p in parts.payloads] == \
        [(tuple(p.shape), p.n_records, p.nbytes) for p in jparts.payloads]
    # codes under the near-tie rule against the reference's latents
    codes = full.payloads[0].unpack().reshape(N, -1)
    jcodes = torch.from_numpy(np.array(jfull.payloads[0].unpack())) \
        .reshape(N, -1)
    cb = np.asarray(jserver.params["codebook"], np.float64)
    touched = np.zeros(cb.shape[0], bool)
    n_diff = 0
    for i in range(N):
        z, _ = JOC.client_encode(jserver.params, jcfg,
                                 jnp.asarray(pool[i % len(pool)]))
        zi = np.asarray(z, np.float64).reshape(-1, cb.shape[1])
        sc = torch.from_numpy((cb * cb).sum(-1)[None, :] - 2 * zi @ cb.T)
        d, out = ref.code_mismatches(codes[i], jcodes[i], sc)
        assert out == 0
        n_diff += d
        bad = (codes[i] != jcodes[i]).numpy()
        touched[codes[i].numpy()[bad]] = True
        touched[jcodes[i].numpy()[bad]] = True
    assert n_diff <= max(1, 1e-3 * codes.numel())
    got = OC.server_merge_stats(server, parts.stats).params["codebook"]
    want = np.asarray(JOC.server_merge_stats(jserver, jparts.stats)
                      .params["codebook"])
    live = ~touched
    np.testing.assert_allclose(got.numpy()[live], want[live], rtol=TOL,
                               atol=TOL)


def test_driver_traffic_matches_reference(twins, capsys):
    cfg, jcfg, server, jserver, pool = twins
    kw = dict(n_clients=24, parity_clients=16, parity_cohort=4, cohort=8,
              traffic_slots=64, traffic_cohort=8)
    with dispatch_monitor() as n:
        out = P.run(cfg, device="cpu", server=server, pool=pool, **kw)
    text = capsys.readouterr().out
    assert "streamed round bit-matches one-shot round" in text
    assert "samples decoded version-correctly" in text
    assert n.encode_dispatches == out["encode_dispatches"]
    wire = out["wire"]
    assert n.decode_dispatches == len(wire.store.versions)
    # the reference's traffic from the reference's merged population round
    jeng = JCohort(jcfg, gamma=0.99, n_local_steps=0)
    jround = jeng.round(jserver, JPlan.build(np.arange(24), 8),
                        jdata_fn(pool))
    jwire = JW.OctopusServer(JOC.server_merge_stats(jserver, jround.stats),
                             jcfg)
    jhist = jeng.run_traffic(
        jwire, JScheduler(64, JSchedConfig(participation=0.5,
                                           straggler_prob=0.3,
                                           drop_prob=0.05),
                          key=jax.random.PRNGKey(P.SCHED_KEY),
                          profile=JDiurnal(period=6, trough=0.25),
                          quantum=8),
        jdata_fn(pool), cohort_size=8, n_rounds=6, merge_every=3)
    assert [tuple(h) for h in out["traffic"]] == [tuple(h) for h in jhist]
    assert wire.registry.latest == jwire.registry.latest == 2
    assert [h.merged_version for h in out["traffic"]
            if h.merged_version] == [1, 2]
    for r in wire.store.records:
        feats = OC.codes_to_features(cfg, r.packed,
                                     wire.registry.get(r.version))
        cb = wire.registry.get(r.version)
        assert torch.equal(feats, cb[r.packed.unpack().long()])
    assert out["n_features"] == wire.store.n_samples
