"""Batched serving driver: a prompt batch, then greedy decode through the
serve step (KV caches).

Port of ``repro.launch.serve``. Runs on the CUDA device unless
``--device cpu`` is given; weights are drawn by
:func:`repro_torch.models.transformer.init_lm` on that device from
``--seed``, prompts come from the port's ``make_tokens``.

    python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --batch 8 --prompt-len 128 --gen 128
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch jamba-v0.1-52b --smoke --device cpu
    python -m repro_torch.launch.serve --arch xlstm-350m \\
        --batch 8 --prompt-len 128 --gen 128
    python -m repro_torch.launch.serve --arch starcoder2-3b \\
        --batch 2 --prompt-len 128 --gen 128
    python -m repro_torch.launch.serve --arch whisper-base \\
        --batch 8 --prompt-len 128 --gen 128
    python -m repro_torch.launch.serve --arch gemma-7b \\
        --batch 8 --prompt-len 128 --gen 128
    python -m repro_torch.launch.serve --arch minicpm3-4b \\
        --batch 8 --prompt-len 128 --gen 128
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch gemma-7b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch minicpm3-4b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-v3-671b --smoke --device cpu

``main`` takes the reference's route: a (data, model) mesh over the
process group (:func:`repro_torch.launch.mesh.make_host_mesh`; one rank
when started alone, N under ``torchrun --nproc-per-node N -m
repro_torch.launch.serve ...``), the mesh serve step
(``distributed.steps.build_serve_step``) and parameters sharded by its
specs. :func:`generate` runs one device unless given a ``mesh``.

An encoder-decoder (whisper-base) encodes frames drawn as the reference's
launcher draws them, ``jax.random.normal(PRNGKey(seed), (B, n_audio_frames,
d_model))`` (:mod:`repro_torch.prng`), once, and passes the encoder's
output to every serve step.

gemma-7b (31.8 GiB of float32 weights, head dim 256) and minicpm3-4b
(15.9 GiB, Multi-head Latent Attention) run at full width and depth on
one 80 GB card.

The full ``jamba-v0.1-52b`` (32 layers, 192 GiB in float32) and
``deepseek-v3-671b`` (61 layers, 671.6 B parameters) need more than one
card: ``torchrun`` over several cards shards them by the mesh's specs.
``chip_smoke.py`` runs one 8-layer period of Jamba and deepseek-v3's first
4 layers (3 dense, 1 MoE; 58.9 GiB with its train-time MTP head, which
serving draws but never runs) on one card.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import prng
from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.synthetic import make_tokens
from repro_torch.distributed import steps as S
from repro_torch.distributed.sharding import shard_tree
from repro_torch.launch.mesh import init_world, make_host_mesh
from repro_torch.models import transformer as T


def audio_frames(cfg, batch: int, seed: int, device) -> torch.Tensor:
    """The reference launcher's stub frames, ``jax.random.normal(PRNGKey(
    seed), (batch, n_audio_frames, d_model))``, on ``device``."""
    shape = (batch, cfg.n_audio_frames, cfg.d_model)
    return torch.from_numpy(prng.normal(prng.prng_key(seed), shape)) \
        .to(device)


def generate(params, cfg, prompts: torch.Tensor, gen: int, *,
             step=S.serve_step, enc_out=None, mesh=None) -> torch.Tensor:
    """(B, P) prompts -> (B, P + gen) tokens, the prompt then ``gen``
    greedy tokens.

    As the reference's driver does, the prompt also goes in token by token
    through the serve step (the decode path; production prefill is
    :func:`repro_torch.distributed.steps.prefill_step`): ``P + gen - 1``
    steps against one cache of ``P + gen`` positions. ``step`` is the
    serve step, replaceable by a caller that wraps it (to time it).
    ``enc_out``: an encoder-decoder's encoder output, passed to every
    step. With a ``mesh`` the parameters are sharded by
    ``build_serve_step``'s specs and the step is that builder's, on caches
    sharded by its specs; the tokens come back whole on every rank."""
    B, P = prompts.shape
    max_len = P + gen
    caches = T.init_caches(cfg, B, max_len, device=prompts.device)
    if mesh is not None:
        mesh_step = S.build_serve_step(
            cfg, mesh, ShapeConfig("serve", max_len, B, "decode"))[0]
        caches = S.shard_caches(caches, cfg, mesh, batch=B)

        def step(params, cfg, tok, caches, t, enc_out=None):
            nxt, caches = mesh_step(params, tok, caches, t, enc_out)
            return nxt.full_tensor(), caches
    tok = prompts[:, :1]
    out = [tok]
    for t in range(max_len - 1):
        nxt, caches = step(params, cfg, tok, caches, t, enc_out=enc_out)
        tok = prompts[:, t + 1:t + 2] if t + 1 < P else nxt
        out.append(tok)
    return torch.cat(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = init_world(args.device)
    mesh = make_host_mesh(device=dev.type)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    max_len = args.prompt_len + args.gen
    in_specs = S.build_serve_step(
        cfg, mesh, ShapeConfig("serve", max_len, args.batch, "decode"))[1]
    params = shard_tree(T.init_lm(torch.Generator(dev).manual_seed(
        args.seed), cfg, device=dev), in_specs["params"], mesh)
    prompts = make_tokens(torch.Generator().manual_seed(args.seed),
                          args.batch, args.prompt_len,
                          cfg.vocab_size).to(dev)

    t0 = time.time()
    enc = None
    if cfg.is_encoder_decoder:
        with S.mesh_context(mesh):
            enc = T.encode_audio(params, cfg, audio_frames(
                cfg, args.batch, args.seed, dev))
    seqs = generate(params, cfg, prompts, args.gen, enc_out=enc, mesh=mesh)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    print(f"arch={cfg.name} generated {args.batch}x{args.gen} tokens "
          f"in {dt:.2f}s ({args.batch * max_len / dt:.1f} tok/s)")
    print("first sequence:", seqs[0, :48].tolist())
    return seqs


if __name__ == "__main__":
    main()
