"""Ranks of a gloo process group for the port's mesh tests.

Not a test module: ``tests/test_torch_mesh.py`` and
``tests/test_torch_moe_ep.py`` start this file as N processes,

    python tests/torch_mesh_workers.py JOB RANK WORLD DIR

with the job's inputs in ``DIR/in.npz``. The ranks join one group through
a ``FileStore`` in ``DIR`` (no port, so test workers never collide), each
collective gives up after 60 s, and rank 0 writes the job's results to
``DIR/out.npz``. A rank imports torch, numpy and ``repro_torch`` only: no
JAX and nothing of the JAX package. Jobs:

* ``lm``: for each of ``archs`` and each mesh shape in ``meshes``, the
  sharded prefill logits, greedy decode (tokens and caches) and train
  steps (each loss and first moment; after the last, the parameters and
  the second moment too) of the arch's SMOKE config on the reference's
  weights (``ARCH/flat/...``).
* ``moe``: the expert-parallel and bucketed dispatch on a (2, 2) mesh, at
  each capacity factor in ``factors``: y and aux.
* ``ema``: ``ema_update_distributed`` over the data group.
* ``sim``: one ``SimEngine(mesh=)`` round and ``round_indices``.
"""
from __future__ import annotations

import os
import sys
import traceback
from datetime import timedelta

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

TIMEOUT = timedelta(seconds=60)


def run_group(job: str, where: str, world: int = 4, *,
              deadline: float = 240.0):
    """Start ``world`` ranks of ``job`` on ``where`` (which holds
    ``in.npz``) and wait for them all, at most ``deadline`` seconds in
    all; a rank that fails or outlives the deadline fails the call (the
    others are killed). -> the arrays of ``out.npz``."""
    import subprocess
    import time
    env = dict(os.environ, OMP_NUM_THREADS="1")
    logs = [open(os.path.join(where, f"rank{r}.log"), "w")
            for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), job,
                               str(r), str(world), where], env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    end = time.monotonic() + deadline
    try:
        for p in procs:
            p.wait(timeout=max(end - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"{job}: the group outlived {deadline} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode]
    if bad:
        with open(os.path.join(where, f"rank{bad[0]}.log")) as f:
            raise RuntimeError(f"{job}: rank {bad[0]} failed\n"
                               f"{f.read()[-4000:]}")
    with np.load(os.path.join(where, "out.npz")) as data:
        return dict(data)


def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(int(s) for s in shape),
                            mesh_dim_names=("data", "model"))


def _full(t):
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().numpy().copy()


def _flat_in(data, prefix):
    return {k[len(prefix):]: data[k] for k in data.files
            if k.startswith(prefix)}


# --------------------------------------------------------------------- lm

def job_lm(data, out):
    from repro_torch.configs import TrainConfig, smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
    from repro_torch.distributed import steps as S
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import leaves

    tkw = {k[len("tcfg/"):]: data[k].item() for k in data.files
           if k.startswith("tcfg/")}
    tcfg = TrainConfig(**tkw)
    prompts = torch.from_numpy(data["prompts"])
    B, L = prompts.shape
    n_gen = int(data["n_gen"])
    meshes = [tuple(int(s) for s in m) for m in data["meshes"]]
    for arch in (str(a) for a in data["archs"]):
        cfg = smoke_config(arch)
        flat = _flat_in(data, f"{arch}/flat/")
        for shape in meshes:
            mesh = _mesh(shape)
            tag = f"{arch}/" + "x".join(map(str, shape))
            step, in_specs, _, _ = S.build_prefill_step(
                cfg, mesh, ShapeConfig("test", L, B, "prefill"))
            params = lm_params_from_numpy(flat, cfg, device="cpu",
                                          mesh=mesh, specs=in_specs[0])
            out[f"{tag}/prefill"] = _full(step(params, {"tokens": prompts}))
            # greedy decode: the prompt token by token, then n_gen tokens
            total = L + n_gen
            serve = S.build_serve_step(
                cfg, mesh, ShapeConfig("test", total, B, "decode"))[0]
            caches = S.shard_caches(T.init_caches(cfg, B, total,
                                                  device="cpu"),
                                    cfg, mesh, batch=B)
            tok, toks = prompts[:, :1], []
            for t in range(total - 1):
                nxt, caches = serve(params, tok, caches, t)
                nxt = torch.from_numpy(_full(nxt))
                tok = prompts[:, t + 1:t + 2] if t + 1 < L else nxt
                if t + 1 >= L:
                    toks.append(nxt)
            out[f"{tag}/tokens"] = torch.cat(toks, 1).numpy()
            for s, c in enumerate(caches):
                for f, t in zip(c._fields, c):
                    out[f"{tag}/cache/{s}/{f}"] = _full(t)
            del params, caches
            # two train steps on this mesh's batches
            batches = data["batches/" + "x".join(map(str, shape))]
            train = S.build_train_step(
                cfg, tcfg, mesh, ShapeConfig("test", batches.shape[2],
                                             batches.shape[1], "train"))[0]
            state = S.shard_state(S.init_train_state(lm_params_from_numpy(
                flat, cfg, device="cpu")), cfg, mesh)
            for i, toks_i in enumerate(batches):
                state, loss = train(state, {"tokens": torch.from_numpy(
                    toks_i)})
                out[f"{tag}/step{i}/loss"] = np.float32(float(loss))
                # the first step's mean moment carries its gradient; the
                # last step's state is gathered whole
                last = i == len(batches) - 1
                for name, got in (("param", leaves(state.params)),
                                  ("mu", state.opt.mu),
                                  ("nu", state.opt.nu)):
                    if name != "mu" and not last:
                        continue
                    tree = _like(state.params, [torch.from_numpy(_full(p))
                                                for p in got])
                    for k, v in lm_params_to_numpy(tree, cfg).items():
                        out[f"{tag}/step{i}/{name}/{k}"] = v
            del state


def _like(params, flat):
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v) for v in node]
        return next(it)

    return build(params)


def job_moe_ep(data, out):
    """The MoE layer's mesh layouts, ``ema_update_distributed`` and a
    sharded ``SimEngine``, all on one (2, 2) mesh."""
    import dataclasses

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import hints
    from repro_torch.configs import smoke_config
    from repro_torch.convert import load_npz
    from repro_torch.core import octopus as OC
    from repro_torch.core.dvqae import DVQAEConfig
    from repro_torch.core.ema import EMAState, ema_update_distributed
    from repro_torch.distributed import sharding as shd
    from repro_torch.nn.moe import moe_apply
    from repro_torch.sim import SimEngine

    mesh = _mesh((2, 2))
    group, r = shd.data_group(mesh)
    base = smoke_config(str(data["moe_arch"]))
    moe = {k[len("moe/"):]: torch.from_numpy(data[k]) for k in data.files
           if k.startswith("moe/")}
    tree = {"router": moe["router"],
            "experts": {n: moe[f"experts/{n}"] for n in ("wi", "wg", "wo")}}
    if "shared/wi" in moe:
        tree["shared"] = {n: moe[f"shared/{n}"] for n in ("wi", "wg", "wo")}
    # the layer's parameters laid out as a segment's are
    specs = {"router": shd.P(None, "model"),
             "experts": {n: shd.P("model", None, None)
                         for n in ("wi", "wg", "wo")},
             "shared": {"wi": shd.P(None, "model"),
                        "wg": shd.P(None, "model"),
                        "wo": shd.P("model", None)}}
    params = shd.shard_tree(tree, {k: specs[k] for k in tree}, mesh)
    x = shd.shard_tree(torch.from_numpy(data["moe_x"]),
                       shd.P("data", None, None), mesh)
    for dispatch in ("shardmap", "bucketed"):
        for cf in data["factors"]:
            cfg = base.replace(moe=dataclasses.replace(
                base.moe, capacity_factor=float(cf), dispatch=dispatch))
            with hints.activation_sharding(mesh, ("data",)), \
                    implicit_replication(), torch.no_grad():
                y, aux = moe_apply(params, cfg, x, activation=cfg.activation)
            out[f"moe/{dispatch}/{float(cf)}/y"] = _full(y)
            out[f"moe/{dispatch}/{float(cf)}/aux"] = _full(aux)
    # the EMA refresh from each data shard's latents and codes
    half = data["ema_z"].shape[0] // 2
    state = EMAState(*(torch.from_numpy(data[f"ema_state/{f}"])
                       for f in EMAState._fields))
    for gamma in data["ema_gammas"]:
        new = ema_update_distributed(
            state, torch.from_numpy(data["ema_z"][r * half:(r + 1) * half]),
            torch.from_numpy(data["ema_idx"][r * half:(r + 1) * half]),
            gamma=float(gamma), group=group)
        for f, t in zip(EMAState._fields, new):
            out[f"ema/{float(gamma)}/{f}"] = t.numpy().copy()
    # one sharded SimEngine round (and round_indices) per local-step count
    cfg = DVQAEConfig(**{k[len("sim_cfg/"):]: data[k].item()
                         for k in data.files if k.startswith("sim_cfg/")})
    server = OC.ServerState(params=load_npz(str(data["sim_params"]), cfg,
                                            device="cpu"))
    images = data["sim_images"]
    for steps in (0, 1):
        eng = SimEngine(cfg, gamma=0.9, n_local_steps=steps, mesh=mesh)
        clients, payload = eng.round(eng.init_clients(server,
                                                      images.shape[0]),
                                     images)
        out[f"sim/{steps}/words"] = payload.payload.numpy().copy()
        out[f"sim/{steps}/shape"] = np.array(payload.shape)
        for f, t in zip(EMAState._fields, clients.ema):
            out[f"sim/{steps}/ema/{f}"] = t.numpy().copy()
        out[f"sim/{steps}/codebook"] = clients.params["codebook"].numpy()
        out[f"sim/{steps}/step"] = clients.step.numpy()
        if steps:
            for i, m in enumerate(clients.params["encoder"]):
                for k, v in m.state_dict().items():
                    out[f"sim/{steps}/encoder/{i}/{k}"] = v.numpy().copy()
        clients, codes = eng.round_indices(
            eng.init_clients(server, images.shape[0]), images)
        out[f"sim/{steps}/codes"] = codes.numpy()


JOBS = {"lm": job_lm, "moe_ep": job_moe_ep}


def main(argv):
    job, rank, world, where = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(where, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        data = np.load(os.path.join(where, "in.npz"), allow_pickle=False)
        out = {}
        JOBS[job](data, out)
        out["jax_or_reference_imported"] = np.array(any(
            n in ("jax", "repro") or n.startswith(("jax.", "repro."))
            for n in sys.modules))
        if rank == 0:
            np.savez(os.path.join(where, "out.tmp.npz"), **out)
            os.replace(os.path.join(where, "out.tmp.npz"),
                       os.path.join(where, "out.npz"))
    except Exception:
        traceback.print_exc()
        with open(os.path.join(where, f"error.{rank}"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
