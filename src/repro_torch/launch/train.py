"""End-to-end LM training on one device: the launcher.

Port of ``repro.launch.train``: the same flags plus ``--device``. Runs on
the CUDA device unless ``--device cpu`` is given:

    python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 20 --batch 8 --seq 1024
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch deepseek-v3-671b --smoke --device cpu

``--smoke`` uses the reduced config. A config with the MTP head
(deepseek-v3) trains on ``lm_loss`` with its MTP term; an encoder-decoder
(``--arch whisper-base``) on ``lm_loss`` against ``encode_audio`` of step
``i``'s frames. Weights are drawn by ``models.transformer.init_lm`` on the
run's device from ``--seed``; step ``i``'s batch is ``make_tokens`` from a
CPU generator seeded by ``(seed, i)`` (:func:`batch_at`), and an
encoder-decoder's frames N(0, 1) from another CPU generator seeded the
same way (:func:`frames_at`). The reference draws both from ``jax.random``
keys folded from the seed (its frames ``jax.random.normal``), so the two
packages' batches differ: the port does not reproduce that key stream,
which at whisper-base's 8 x 1,500 x 512 frames would cost ~16 s a draw in
numpy (``prng.normal``). With ``--ckpt-dir`` the state is saved every
``--ckpt-every`` steps (``checkpoint.save``, the reference's file layout)
and the latest
checkpoint is restored at start; the run then goes on from its step (the
reference restarts its loop at 0 with the restored state). ``main`` takes
the reference's route: a (data, model) mesh over the process group
(:func:`repro_torch.launch.mesh.make_host_mesh`; one rank when started
alone, N under ``torchrun --nproc-per-node N -m repro_torch.launch.train
...``), the mesh train step (``distributed.steps.build_train_step(cfg,
tcfg, mesh, shape)``) and a state sharded by its specs; checkpoints hold
whole tensors (rank 0 writes them). :func:`train` runs one device unless
given a ``mesh``.
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint import restore, save
from repro_torch.configs import TrainConfig, get_config, smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.synthetic import make_tokens
from repro_torch.distributed import steps as S
from repro_torch.launch.mesh import init_world, make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import leaves


def batch_at(seed: int, step: int, batch: int, seq: int, vocab: int,
             device) -> torch.Tensor:
    """Step ``step``'s (batch, seq) int32 tokens, drawn on the CPU from a
    generator seeded by ``(seed, step)`` and moved to ``device``."""
    g = torch.Generator().manual_seed((seed << 32) + step)
    return make_tokens(g, batch, seq, vocab).to(device)


def frames_at(seed: int, step: int, batch: int, cfg, device
              ) -> torch.Tensor:
    """Step ``step``'s (batch, n_audio_frames, d_model) float32 frames of
    an encoder-decoder, N(0, 1) drawn on the CPU from a generator seeded by
    ``(seed, step)`` and moved to ``device``."""
    g = torch.Generator().manual_seed((seed << 32) + step)
    return torch.randn((batch, cfg.n_audio_frames, cfg.d_model),
                       generator=g).to(device)


def init_state(cfg, seed: int, device) -> S.TrainState:
    """Step 0: ``init_lm`` weights from ``seed`` on ``device``, zero
    moments (``device``: cuda unless "cpu")."""
    device = resolve_device(device)
    params = T.init_lm(torch.Generator(device).manual_seed(seed), cfg,
                       device=device)
    return S.init_train_state(params)


def train(state: S.TrainState, cfg, tcfg: TrainConfig, *, steps: int,
          batch: int, seq: int, seed: int = 0, log_every: int = 10,
          ckpt_dir: str = "", ckpt_every: int = 50, wrap=None, mesh=None):
    """Run steps ``state.step`` to ``steps - 1`` -> (state, the losses as
    0-d tensors on the device). ``wrap``, if given, takes the train step
    (``build_train_step(cfg, tcfg)``) and returns the function to call in
    its place (e.g. one that times it). With a ``mesh`` the state is
    :func:`repro_torch.distributed.steps.shard_state`'s and the step the
    mesh step; every rank draws the same batches."""
    if mesh is None:
        step_fn = S.build_train_step(cfg, tcfg)
    else:
        step_fn = S.build_train_step(cfg, tcfg, mesh,
                                     ShapeConfig("cli", seq, batch,
                                                 "train"))[0]
    if wrap is not None:
        step_fn = wrap(step_fn)
    dev = leaves(state.params)[0].device
    losses = []
    first, t0 = state.step, time.time()
    for i in range(state.step, steps):
        data = {"tokens": batch_at(seed, i, batch, seq, cfg.vocab_size,
                                   dev)}
        if cfg.is_encoder_decoder:
            data["frames"] = frames_at(seed, i, batch, cfg, dev)
        state, loss = step_fn(state, data)
        losses.append(loss)
        if i % log_every == 0 or i == steps - 1:
            done = float(loss)                  # waits for the step
            tok_s = batch * seq * (i + 1 - first) / (time.time() - t0)
            print(f"step {i:5d} loss {done:.4f} ({tok_s:,.0f} tok/s)",
                  flush=True)
        if ckpt_dir and (i + 1) % ckpt_every == 0:
            whole = state if mesh is None else S.unshard_state(state)
            if mesh is None or dist.get_rank() == 0:
                save(ckpt_dir, i + 1, whole, metadata={"arch": cfg.name})
    return state, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = init_world(args.device)
    mesh = make_host_mesh(device=dev.type)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=max(1, args.steps // 10))
    print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"device={dev} mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    state = init_state(cfg, args.seed, dev)
    if args.ckpt_dir:
        restored, at = restore(args.ckpt_dir, state)
        if restored is not None:
            state = restored
            print(f"restored checkpoint at step {at}")
    state = S.shard_state(state, cfg, mesh)
    t0 = time.time()
    state, losses = train(state, cfg, tcfg, steps=args.steps,
                          batch=args.batch, seq=args.seq, seed=args.seed,
                          log_every=args.log_every, ckpt_dir=args.ckpt_dir,
                          ckpt_every=args.ckpt_every, mesh=mesh)
    final = f"{float(losses[-1]):.4f}" if losses else "n/a"
    print(f"done in {time.time() - t0:.1f}s; final loss {final}")
    return S.unshard_state(state), [float(x) for x in losses]


if __name__ == "__main__":
    main()
