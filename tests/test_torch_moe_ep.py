"""Expert parallelism, the bucketed MoE dispatch, the distributed EMA
refresh and the sharded population engine, on a (2, 2) mesh, against the
JAX package.

The reference runs in a process of its own with 4 forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``): its
``_moe_shardmap`` and its ``bucketed`` ``moe_apply`` under ``jax.jit`` on
``jax.make_mesh((2, 2), ("data", "model"))``, and ``ema_update_distributed``
under ``jax.shard_map``. Its results come here as numpy; the port's come
from one 4-rank gloo group (``tests/torch_mesh_workers.py``, job
``moe_ep``: no JAX there), which runs beside it.

* MoE (deepseek-v3's SMOKE layer: 4 experts, top 2, sigmoid routing, a
  shared expert; 4 x 8 tokens): capacity factor 1.0, where capacity and
  slot positions are per data shard (``shardmap``) or per (data shard,
  expert) (``bucketed``) and assignments drop, and 8.0, where none do.
  y within 1e-5 of its largest element, aux within 1e-6 relative.
* ``ema_update_distributed`` over the data group at gamma 0 (the refresh
  is then the summed statistics: counts n exact) and 0.9: sums, codebook
  and counts within 1e-6 of 1 + |x|.
* ``SimEngine(mesh=)`` (2 clients a data shard) against the reference's
  plain-vmap ``SimEngine`` at ``n_local_steps=0``: codes equal but at near
  ties, words equal where the codes are, EMA and codebooks within
  ``tests/test_torch_sim.py``'s 1e-5 of 1 + |x|; and against the port's
  unsharded engine at 0 and 1 local steps bit for bit (words, EMA,
  codebooks, steps, each client's fine-tuned encoder, ``round_indices``'
  codes). The reference's own shard-mapped engine fails its test on this
  JAX (``tests/test_sim.py::test_engine_sharded_matches_unsharded``).
"""
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.npz import save_pytree  # noqa: E402
from repro.core import octopus as JOC  # noqa: E402
from repro.core.dvqae import DVQAEConfig as JConfig  # noqa: E402
from repro.sim import SimEngine as JEngine  # noqa: E402
from repro_torch.convert import load_npz  # noqa: E402
from repro_torch.core import octopus as OC  # noqa: E402
from repro_torch.core.dvqae import DVQAEConfig  # noqa: E402
from repro_torch.sim import SimEngine  # noqa: E402
from test_torch_sim import near_ties_ok  # noqa: E402
from torch_mesh_workers import run_group  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
MOE_ARCH = "deepseek-v3-671b"
FACTORS = (1.0, 8.0)
Y_RTOL = 1e-5                    # of y's largest element
AUX_RTOL = 1e-6
EMA_TOL = 1e-6                   # of 1 + |x|
EMA_GAMMAS = (0.0, 0.9)
SIM_TOL = 1e-5                   # tests/test_torch_sim.py's, of 1 + |x|
TINY = dict(kind="image", in_channels=3, hidden=8, latent_dim=8,
            codebook_size=16, n_res_blocks=1)
N_CLIENTS, PER_CLIENT = 4, 2

REFERENCE = r'''
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import hints
from repro.configs import smoke_config
from repro.core.ema import EMAState, ema_update_distributed
from repro.nn import moe as MOE

where = sys.argv[1]
data = np.load(where + "/ref_in.npz")
mesh = jax.make_mesh((2, 2), ("data", "model"))
base = smoke_config(str(data["moe_arch"]))
prm = {k[4:]: jnp.asarray(data[k]) for k in data.files if k.startswith("moe/")}
params = {"router": prm["router"],
          "experts": {n: prm["experts/" + n] for n in ("wi", "wg", "wo")}}
if "shared/wi" in prm:
    params["shared"] = {n: prm["shared/" + n] for n in ("wi", "wg", "wo")}
x = jnp.asarray(data["moe_x"])
out = {}
for cf in data["factors"]:
    cf = float(cf)
    cfg = base.replace(moe=dataclasses.replace(base.moe, capacity_factor=cf))
    y, aux = jax.jit(lambda p, x: MOE._moe_shardmap(
        p, cfg, x, mesh, ("data",), cfg.activation))(params, x)
    out[f"moe/shardmap/{cf}/y"], out[f"moe/shardmap/{cf}/aux"] = y, aux
    bcfg = base.replace(moe=dataclasses.replace(
        base.moe, capacity_factor=cf, dispatch="bucketed"))

    def bucketed(p, x):
        with hints.activation_sharding(mesh, ("data",)):
            return MOE.moe_apply(p, bcfg, x, activation=bcfg.activation)
    y, aux = jax.jit(bucketed)(params, x)
    out[f"moe/bucketed/{cf}/y"], out[f"moe/bucketed/{cf}/aux"] = y, aux
state = EMAState(*(jnp.asarray(data["ema_state/" + f])
                   for f in EMAState._fields))
for gamma in data["ema_gammas"]:
    gamma = float(gamma)
    new = jax.jit(jax.shard_map(
        lambda s, z, i: ema_update_distributed(s, z, i, gamma=gamma,
                                               axis_name="data"),
        mesh=mesh, in_specs=(P(), P("data"), P("data")), out_specs=P(),
        check_vma=False))(state, jnp.asarray(data["ema_z"]),
                          jnp.asarray(data["ema_idx"]))
    for f, t in zip(EMAState._fields, new):
        out[f"ema/{gamma}/{f}"] = t
np.savez(where + "/ref_out.npz", **{k: np.asarray(v) for k, v in out.items()})
'''


def _inputs(where):
    """The MoE layer's weights and tokens, the EMA state and batch, and
    the population engine's server, all from numpy seeds; the shared
    arrays as the ranks' and the reference's inputs."""
    from repro_torch.configs import smoke_config
    from repro_torch.convert import init_numpy_lm_params
    rng = np.random.default_rng(34)
    cfg = smoke_config(MOE_ARCH)
    flat = init_numpy_lm_params(cfg, 7)
    seg = next(s for s in range(4) if f"segments/{s}/ffn/router" in flat)
    pre = f"segments/{seg}/ffn/"
    shared = {"moe/" + k[len(pre):]: v[0] for k, v in flat.items()
              if k.startswith(pre)}
    shared.update(moe_arch=np.array(MOE_ARCH), factors=np.array(FACTORS),
                  moe_x=rng.standard_normal((4, 8, cfg.d_model))
                  .astype(np.float32))
    K, M = 16, 8
    shared.update({"ema_state/counts": rng.random(K).astype(np.float32) + 1,
                   "ema_state/sums": rng.standard_normal((K, M))
                   .astype(np.float32),
                   "ema_state/codebook": rng.standard_normal((K, M))
                   .astype(np.float32),
                   "ema_z": rng.standard_normal((6, 5, M)).astype(np.float32),
                   "ema_idx": rng.integers(0, K, (6, 5)).astype(np.int32),
                   "ema_gammas": np.array(EMA_GAMMAS)})
    np.savez(os.path.join(where, "ref_in.npz"), **shared)
    jcfg = JConfig(**TINY)
    jserver = JOC.server_init(jax.random.PRNGKey(0), jcfg)
    params_path = os.path.join(where, "params.npz")
    save_pytree(params_path, jserver.params)
    images = rng.standard_normal((N_CLIENTS, PER_CLIENT, 8, 8, 3)) \
        .astype(np.float32)
    ranks = dict(shared, sim_params=np.array(params_path),
                 sim_images=images,
                 **{f"sim_cfg/{k}": np.array(v) for k, v in TINY.items()})
    np.savez(os.path.join(where, "in.npz"), **ranks)
    return jserver, jcfg, params_path, images


def _reference(where):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", REFERENCE, where],
                         capture_output=True, text=True, env=env,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    with np.load(os.path.join(where, "ref_out.npz")) as data:
        return dict(data)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the group's results, the reference's, the reference's engine
    round, the port's unsharded engine rounds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    where = str(tmp_path_factory.mktemp("moe_ep"))
    try:
        jserver, jcfg, params_path, images = _inputs(where)
        got, errors = {}, []

        def group():
            try:
                got.update(run_group("moe_ep", where))
            except Exception as e:       # raised below, in the test
                errors.append(e)

        worker = threading.Thread(target=group)
        worker.start()
        try:
            ref = _reference(where)
            jeng = JEngine(jcfg, gamma=0.9, n_local_steps=0)
            jround = jeng.round(jeng.init_clients(jserver, N_CLIENTS),
                                jnp.asarray(images))
            z = [np.asarray(JOC.client_encode(
                jserver.params, jcfg, jnp.asarray(images[i]))[0])
                for i in range(N_CLIENTS)]
            cfg = DVQAEConfig(**TINY)
            server = OC.ServerState(params=load_npz(params_path, cfg,
                                                    device="cpu"))
            plain = {}
            for steps in (0, 1):
                eng = SimEngine(cfg, gamma=0.9, n_local_steps=steps)
                plain[steps] = (
                    eng.round(eng.init_clients(server, N_CLIENTS), images),
                    eng.round_indices(eng.init_clients(server, N_CLIENTS),
                                      images))
        finally:
            worker.join()
        if errors:
            raise errors[0]
        return got, ref, (jround, z, jserver), plain
    finally:
        torch.set_num_threads(n)


def test_ranks_import_neither_jax_nor_the_reference(runs):
    assert not bool(runs[0]["jax_or_reference_imported"])


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("dispatch", ["shardmap", "bucketed"])
def test_moe_layouts_match_the_reference(runs, dispatch, cf):
    got, ref = runs[0], runs[1]
    key = f"moe/{dispatch}/{cf}"
    y, want = got[key + "/y"], ref[key + "/y"]
    assert y.shape == want.shape
    err = float(np.abs(y - want).max())
    assert err <= Y_RTOL * float(np.abs(want).max()), err
    np.testing.assert_allclose(got[key + "/aux"], ref[key + "/aux"],
                               rtol=AUX_RTOL)


def test_capacity_one_drops_and_differs_from_eight(runs):
    """At capacity factor 1.0 assignments drop (per shard), so y moves
    away from the dropless 8.0's, in both packages alike."""
    got, ref = runs[0], runs[1]
    for side in (got, ref):
        for dispatch in ("shardmap", "bucketed"):
            a = side[f"moe/{dispatch}/1.0/y"]
            b = side[f"moe/{dispatch}/8.0/y"]
            assert float(np.abs(a - b).max()) > 1e-3 * float(np.abs(b).max())


@pytest.mark.parametrize("gamma", EMA_GAMMAS)
def test_ema_update_distributed_matches_the_reference(runs, gamma):
    """At gamma 0 the refreshed counts and sums are the all-reduced
    statistics n and s themselves: n exact. At 0.9 XLA contracts the
    refresh's multiply-add into one FMA, so every field is held to the
    tolerance."""
    got, ref = runs[0], runs[1]
    key = f"ema/{gamma}/"
    if gamma == 0.0:
        np.testing.assert_array_equal(got[key + "counts"],
                                      ref[key + "counts"])
    for f in ("counts", "sums", "codebook"):
        err = np.abs(got[key + f] - ref[key + f])
        assert (err <= EMA_TOL * (1 + np.abs(ref[key + f]))).all(), f


def test_sharded_engine_matches_the_reference_engine(runs):
    got, (jround, z, jserver) = runs[0], runs[2]
    jcl, jp = jround
    codes = torch.from_numpy(got["sim/0/codes"])
    jcodes = torch.from_numpy(np.array(jp.unpack()))
    cbs = np.repeat(np.asarray(jserver.params["codebook"])[None],
                    N_CLIENTS, 0)
    n_diff, touched = near_ties_ok(codes, jcodes, z, cbs)
    assert tuple(got["sim/0/shape"]) == tuple(jp.shape)
    if n_diff == 0:
        np.testing.assert_array_equal(got["sim/0/words"],
                                      np.asarray(jp.payload).view(np.int32))
    keep = ~touched
    for g, w in ((got["sim/0/ema/codebook"], jcl.ema.codebook),
                 (got["sim/0/ema/counts"], jcl.ema.counts),
                 (got["sim/0/codebook"], jcl.params["codebook"])):
        np.testing.assert_allclose(g[keep], np.asarray(w)[keep],
                                   rtol=SIM_TOL, atol=SIM_TOL)


@pytest.mark.parametrize("steps", [0, 1])
def test_sharded_engine_is_the_unsharded_engine_bit_for_bit(runs, steps):
    got, plain = runs[0], runs[3][steps]
    (clients, payload), (_, codes) = plain
    np.testing.assert_array_equal(got[f"sim/{steps}/words"],
                                  payload.payload.numpy())
    assert tuple(got[f"sim/{steps}/shape"]) == tuple(payload.shape)
    for f, t in zip(clients.ema._fields, clients.ema):
        np.testing.assert_array_equal(got[f"sim/{steps}/ema/{f}"], t.numpy())
    np.testing.assert_array_equal(got[f"sim/{steps}/codebook"],
                                  clients.params["codebook"].numpy())
    np.testing.assert_array_equal(got[f"sim/{steps}/step"],
                                  clients.step.numpy())
    np.testing.assert_array_equal(got[f"sim/{steps}/codes"], codes.numpy())
    if steps:
        for i, m in enumerate(clients.params["encoder"]):
            for k, v in m.state_dict().items():
                np.testing.assert_array_equal(
                    got[f"sim/{steps}/encoder/{i}/{k}"], v.numpy(),
                    err_msg=f"client {i} {k}")
