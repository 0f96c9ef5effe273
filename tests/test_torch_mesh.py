"""The port's (data, model) mesh path against the JAX package, on a
4-rank gloo group.

One group (``tests/torch_mesh_workers.py``, 4 processes that import
neither JAX nor the JAX package) builds a (2, 2) and a (1, 4)
``DeviceMesh`` in turn and, at the qwen3, jamba and deepseek-v3 ``SMOKE``
configs on the reference's own ``init_lm`` weights (carried in through
``repro_torch.convert``, each rank keeping its shard), runs the mesh steps
of ``repro_torch.distributed.steps``: the sharded prefill's last-position
logits, the prompt then 8 greedy tokens through the sharded serve step
(its caches DTensors), and two train steps. Jamba's scan runs through
``local_map`` with its channels sharded, deepseek's MoE through the
expert-parallel ``_moe_shardmap`` (T > 1) and its MLA prefill on the flash
kernel's padded route (q/k 48 -> 64).

Baselines, computed here while the group runs: the port's unsharded
steps, and the reference's functions as its eager step composes them
(``lm_loss`` and its gradient, ``warmup_cosine``, ``adamw_update``; its
sharded ``jit`` raises on this JAX, ``tests/test_torch_lm_train.py``). A
mesh with 2 data shards trains on the mean of the two shards' losses: the
expert-parallel layer's aux loss is the mean of each data shard's, as the
reference's ``_moe_shardmap`` defines it (its capacity is per shard too;
these configs' capacity factor 4 drops nothing either way). So the
baseline of a step on that mesh is the unsharded loss and gradient of
each half of the batch, averaged, then the step's update; on the (1, 4)
mesh it is the unsharded step itself.

Tolerances, the existing files': logits within 1e-5 of their largest;
greedy tokens equal but at near ties (``ref.near_ties`` of the unsharded
logits); caches within 2e-5 (absolute and relative, as
``tests/test_torch_lm.py``) and a Mamba state within 5e-5
(``tests/test_torch_hybrid.py``); losses 1e-5 relative; after AdamW each
parameter within 1e-4 absolute and each moment within 1e-5 of its leaf's
largest element (``tests/test_torch_lm_train.py``), except where the
baseline's first moment is itself within that rule of 0: the gradient's
sign is noise there and AdamW's step g / (|g| + eps) may take either
sign, so such an element is held within 2 lr. The first step's mean
moment is (1 - b1) times the clipped gradient, so it holds every gradient
to 1e-5 of its leaf's largest element, inside the gradient rule of 1e-4.
The first step runs at the warmup's learning rate 0, so the parameters
are checked after the second.
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

from repro.checkpoint.npz import _flatten_with_paths  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import TrainConfig, smoke_config  # noqa: E402
from repro_torch.convert import (lm_params_from_numpy,  # noqa: E402
                                 lm_params_to_numpy)
from repro_torch.distributed import steps as S  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim.adamw import adamw_update, leaves  # noqa: E402
from repro_torch.optim.schedules import warmup_cosine  # noqa: E402
from test_torch_lm_train import (LOSS_RTOL, MOMENT_RTOL,  # noqa: E402
                                 PARAM_ATOL, _tree_like)
from torch_mesh_workers import run_group  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ("qwen3-0.6b", "jamba-v0.1-52b", "deepseek-v3-671b")
MESHES = ((2, 2), (1, 4))
B, PROMPT, GEN, TRAIN_LEN = 4, 2, 8, 12
LOGIT_RTOL = 1e-5                # of the largest logit
TOL = 2e-5
STATE_TOL = 5e-5                 # a Mamba state (tests/test_torch_hybrid.py)
TRAIN_KW = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
                weight_decay=0.5)


def _tag(mesh):
    return "x".join(map(str, mesh))


def _inputs():
    """The group's inputs: prompts, train batches, the train config, and
    each arch's reference weights (``init_lm(PRNGKey(0))``, jitted),
    path-keyed."""
    rng = np.random.default_rng(34)
    inp = {"archs": np.array(ARCHS), "n_gen": np.array(GEN),
           "meshes": np.array(MESHES),
           "prompts": rng.integers(0, 512, (B, PROMPT)).astype(np.int64)}
    full = rng.integers(0, 512, (2, B, TRAIN_LEN)).astype(np.int64)
    inp["batches/2x2"] = full              # 2 data shards of 2 rows
    inp["batches/1x4"] = full[:, :B // 2]  # one shard's rows
    for k, v in TRAIN_KW.items():
        inp[f"tcfg/{k}"] = np.array(v)
    for arch in ARCHS:
        jcfg = jsmoke_config(arch)
        jp = jax.jit(lambda key: JT.init_lm(key, jcfg))(
            jax.random.PRNGKey(0))
        for k, v in _flatten_with_paths(jp)[0].items():
            inp[f"{arch}/flat/{k}"] = np.asarray(v)
    return inp


def _port_baseline(arch, inp):
    """The port's unsharded prefill, greedy decode (with each step's
    logits) and per-mesh train trajectories (the mean over data shards)."""
    cfg = smoke_config(arch)
    flat = {k[len(arch) + 6:]: v for k, v in inp.items()
            if k.startswith(f"{arch}/flat/")}
    params = lm_params_from_numpy(flat, cfg, device="cpu")
    prompts = torch.from_numpy(inp["prompts"])
    out = {"prefill": S.prefill_step(params, cfg, prompts).numpy()}
    total = PROMPT + GEN
    caches = T.init_caches(cfg, B, total, device="cpu")
    tok, toks, logits = prompts[:, :1], [], []
    with torch.no_grad():
        for t in range(total - 1):
            lg, caches = T.decode_step(params, cfg, tok, caches, t)
            nxt = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
            tok = prompts[:, t + 1:t + 2] if t + 1 < PROMPT else nxt
            if t + 1 >= PROMPT:
                toks.append(nxt)
                logits.append(lg[:, -1])
    out["tokens"] = torch.cat(toks, 1).numpy()
    out["logits"] = torch.stack(logits, 1)
    out["caches"] = {f"{s}/{f}": t.numpy().copy()
                     for s, c in enumerate(caches)
                     for f, t in zip(c._fields, c)}
    tcfg = TrainConfig(**TRAIN_KW)
    for mesh in MESHES:
        state = S.init_train_state(lm_params_from_numpy(flat, cfg,
                                                        device="cpu"))
        steps = []
        for i, toks_i in enumerate(inp[f"batches/{_tag(mesh)}"]):
            halves = torch.from_numpy(toks_i).chunk(mesh[0])
            parts = []
            for h in halves:
                loss = T.lm_loss(state.params, cfg, h, remat=tcfg.remat)
                parts.append((loss.detach(), torch.autograd.grad(
                    loss, leaves(state.params), allow_unused=True,
                    materialize_grads=True)))
            loss = sum(p[0] for p in parts) / mesh[0]
            grads = [sum(g) / mesh[0] for g in zip(*(p[1] for p in parts))]
            lr = warmup_cosine(state.step, base_lr=tcfg.learning_rate,
                               warmup_steps=tcfg.warmup_steps,
                               total_steps=tcfg.total_steps)
            params_i, opt = adamw_update(
                state.params, grads, state.opt, lr=float(lr), b1=tcfg.b1,
                b2=tcfg.b2, weight_decay=tcfg.weight_decay,
                grad_clip=tcfg.grad_clip)
            state = S.TrainState(params_i, opt, state.step + 1)
            steps.append((float(loss), _numpy(state.params, cfg),
                          _numpy(_tree_like(state.params, opt.mu), cfg),
                          _numpy(_tree_like(state.params, opt.nu), cfg)))
        out[f"train/{_tag(mesh)}"] = steps
    return out, flat


def _numpy(tree, cfg):
    return {k: v.copy() for k, v in lm_params_to_numpy(tree, cfg).items()}


# The reference's baselines, in a process of its own whose XLA runs on one
# thread, so that it leaves the cores to the group beside it
REFERENCE = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.checkpoint.npz import _flatten_with_paths
from repro.configs import smoke_config
from repro.configs.base import TrainConfig
from repro.models import transformer as JT
from repro.optim.adamw import adamw_init, adamw_update
from repro.optim.schedules import warmup_cosine

where = sys.argv[1]
data = np.load(where + "/in.npz")
kw = {k[5:]: data[k].item() for k in data.files if k.startswith("tcfg/")}
tc = TrainConfig(**kw)
out = {}
for arch in (str(a) for a in data["archs"]):
    cfg = smoke_config(arch)
    like = jax.eval_shape(lambda: JT.init_lm(jax.random.PRNGKey(0), cfg))
    keys = list(_flatten_with_paths(like)[0])
    jp = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(like),
        [jnp.asarray(data[arch + "/flat/" + k]) for k in keys])
    out[arch + "/prefill"] = jax.jit(
        lambda p, t: JT.prefill(p, cfg, t).logits[:, -1])(
            jp, jnp.asarray(data["prompts"].astype(np.int32)))
    vg = jax.jit(jax.value_and_grad(
        lambda p, t: JT.lm_loss(p, cfg, t, remat=tc.remat)))
    update = jax.jit(lambda p, g, o, lr: adamw_update(
        p, g, o, lr=lr, b1=tc.b1, b2=tc.b2, weight_decay=tc.weight_decay,
        grad_clip=tc.grad_clip))
    for mesh in data["meshes"]:
        tag, dp = "x".join(str(int(m)) for m in mesh), int(mesh[0])
        params, opt = jp, adamw_init(jp)
        for i, toks in enumerate(data["batches/" + tag]):
            parts = [vg(params, jnp.asarray(h.astype(np.int32)))
                     for h in np.split(toks, dp)]
            grads = jax.tree.map(lambda *g: sum(g) / dp,
                                 *(g for _, g in parts))
            lr = warmup_cosine(jnp.int32(i), base_lr=tc.learning_rate,
                               warmup_steps=tc.warmup_steps,
                               total_steps=tc.total_steps)
            params, opt = update(params, grads, opt, lr)
            at = f"{arch}/{tag}/step{i}/"
            out[at + "loss"] = sum(float(l) for l, _ in parts) / dp
            for name, tree in (("param", params), ("mu", opt.mu),
                               ("nu", opt.nu)):
                for k, v in _flatten_with_paths(tree)[0].items():
                    out[at + name + "/" + k] = v
np.savez(where + "/ref_out.npz", **{k: np.asarray(v) for k, v in out.items()})
"""


def _reference(where):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC),
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    out = subprocess.run([sys.executable, "-c", REFERENCE, where],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    with np.load(os.path.join(where, "ref_out.npz")) as data:
        got = dict(data)
    ref = {}
    for arch in ARCHS:
        ref[arch] = {"prefill": got[f"{arch}/prefill"]}
        for mesh in MESHES:
            steps = []
            for i in range(2):
                at = f"{arch}/{_tag(mesh)}/step{i}/"
                steps.append((float(got[at + "loss"]), *(
                    {k[len(at + name) + 1:]: v for k, v in got.items()
                     if k.startswith(at + name + "/")}
                    for name in ("param", "mu", "nu"))))
            ref[arch][f"train/{_tag(mesh)}"] = steps
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the group's results, the port's baselines, the reference's): the
    group, the reference's process and the port's baselines side by
    side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    where = tmp_path_factory.mktemp("mesh")
    try:
        inp = _inputs()
        np.savez(where / "in.npz", **inp)
        got, errors = {}, []

        def call(fn, *args):
            try:
                got[fn.__name__] = fn(*args)
            except Exception as e:       # raised below, in the test
                errors.append(e)

        threads = [threading.Thread(target=call, args=(run_group, "lm",
                                                       str(where))),
                   threading.Thread(target=call, args=(_reference,
                                                       str(where)))]
        for t in threads:
            t.start()
        try:
            port = {a: _port_baseline(a, inp) for a in ARCHS}
        finally:
            for t in threads:
                t.join()
        if errors:
            raise errors[0]
        return got["run_group"], port, got["_reference"]
    finally:
        torch.set_num_threads(n)


PAIRS = [(a, m) for a in ARCHS for m in MESHES]
IDS = [f"{a}-{_tag(m)}" for a, m in PAIRS]


def test_ranks_import_neither_jax_nor_the_reference(runs):
    got, _, _ = runs
    assert not bool(got["jax_or_reference_imported"])


@pytest.mark.parametrize("arch,mesh", PAIRS, ids=IDS)
def test_sharded_prefill_logits(runs, arch, mesh):
    got, port, reference = runs
    logits = got[f"{arch}/{_tag(mesh)}/prefill"]
    for want in (port[arch][0]["prefill"], reference[arch]["prefill"]):
        err = float(np.abs(logits - want).max())
        assert err <= LOGIT_RTOL * float(np.abs(want).max()), err


@pytest.mark.parametrize("arch,mesh", PAIRS, ids=IDS)
def test_sharded_greedy_tokens(runs, arch, mesh):
    got, port, _ = runs
    toks = got[f"{arch}/{_tag(mesh)}/tokens"]
    want = port[arch][0]["tokens"]
    assert toks.shape == (B, GEN)
    differ = toks != want
    if differ.any():
        # from the first difference on the two runs condition on
        # different tokens: only a near tie may start one
        b, t = map(int, np.argwhere(differ)[0])
        ties = ref.near_ties(-port[arch][0]["logits"][:, t]).numpy()
        assert ties[b], f"row {b} step {t}: {toks[b]} vs {want[b]}"


@pytest.mark.parametrize("arch,mesh", PAIRS, ids=IDS)
def test_sharded_decode_caches(runs, arch, mesh):
    got, port, _ = runs
    want = port[arch][0]["caches"]
    for key, w in want.items():
        tol = STATE_TOL if key.endswith("/h") and arch.startswith("jamba") \
            else TOL
        np.testing.assert_allclose(got[f"{arch}/{_tag(mesh)}/cache/{key}"],
                                   w, atol=tol, rtol=tol, err_msg=key)


@pytest.mark.parametrize("arch,mesh", PAIRS, ids=IDS)
def test_sharded_train_losses(runs, arch, mesh):
    got, port, reference = runs
    for i in range(2):
        loss = float(got[f"{arch}/{_tag(mesh)}/step{i}/loss"])
        for side in (port[arch][0], reference[arch]):
            want = side[f"train/{_tag(mesh)}"][i][0]
            np.testing.assert_allclose(loss, want, rtol=LOSS_RTOL,
                                       err_msg=f"step {i}")


def _leaf_close(got, want, rtol, what):
    for key, w in want.items():
        err = float(np.abs(got[key] - w).max())
        top = float(np.abs(w).max())
        assert err <= rtol * top or err == 0.0, f"{what} {key}: {err}/{top}"


@pytest.mark.parametrize("arch,mesh", PAIRS, ids=IDS)
def test_sharded_train_moments_hold_the_gradients(runs, arch, mesh):
    """Both steps' first moments (the first is (1 - b1) times the clipped
    gradient), the last step's second moment."""
    got, port, reference = runs
    tag = f"{arch}/{_tag(mesh)}"
    for i, j, name in ((0, 2, "mu"), (1, 2, "mu"), (1, 3, "nu")):
        mine = _leaves_of(got, f"{tag}/step{i}/{name}/")
        for side in (port[arch][0], reference[arch]):
            want = side[f"train/{_tag(mesh)}"][i][j]
            assert sorted(mine) == sorted(want)
            _leaf_close(mine, want, MOMENT_RTOL, f"step {i} {name}")


def _leaves_of(got, prefix):
    return {k[len(prefix):]: v for k, v in got.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("arch,mesh", PAIRS, ids=IDS)
def test_sharded_train_parameters_after_adamw(runs, arch, mesh):
    """After the second step (the first ran at learning rate 0), each
    parameter within 1e-4 of the baselines'; where the baseline's first
    moment is within the moment rule of 0, the gradient's sign is noise
    and AdamW's step g / (|g| + eps) can take either sign: there within 2
    lr (the verify notes' rule for near-zero gradients)."""
    got, port, reference = runs
    tag = f"{arch}/{_tag(mesh)}"
    mine = _leaves_of(got, f"{tag}/step1/param/")
    initial = port[arch][1]
    for side in (port[arch][0], reference[arch]):
        _, want, mu, _ = side[f"train/{_tag(mesh)}"][1]
        assert sorted(mine) == sorted(want)
        moved = max(float(np.abs(np.asarray(w) - initial[k]).max())
                    for k, w in want.items())
        assert moved >= 0.5 * TRAIN_KW["learning_rate"]
        for key, w in want.items():
            m = np.abs(np.asarray(mu[key]))
            noise = m <= MOMENT_RTOL * float(m.max())
            tol = np.where(noise, 2 * TRAIN_KW["learning_rate"], PARAM_ATOL)
            err = np.abs(mine[key] - np.asarray(w))
            assert (err <= tol).all(), (key, float(err.max()))
