"""Train an LM backbone on OCTOPUS codes: the DVQ-AE as the distributed
tokenizer, its uplink codes the server-side backbone's tokens.

    python -m repro_torch.train_lm_on_codes --steps 200
    PYTHONPATH=src python -m repro_torch.train_lm_on_codes --small \\
        --steps 5 --device cpu

The PyTorch copy of ``examples/train_lm_on_codes.py``, with the same
steps and printed lines, on ``cuda`` unless ``--device cpu``. A speech
DVQ-AE (hidden 32, M 16, K 256, one residual block) pretrains for 100
steps on batches of 16 of 256 clips (256 frames x 16 channels); a client
transmits all 256 clips as one ``CodePayload`` and ``payload.unpack()``
gives (256, 64) codes in [0, 256). A qwen3-family backbone (12 layers, d
768, 12/4 heads of 64, d_ff 2,048, vocab 256, tied embeddings: 75.7 M
parameters; ``--small``: the SMOKE config with vocab 256) then trains on
batches of code sequences through ``distributed.steps.build_train_step``.

Data, weights and every batch come from ``--seed``; the reference draws
with ``jax.random``, so the two print other figures.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import TrainConfig, smoke_config
from repro_torch.core.dvqae import DVQAEConfig
from repro_torch.data.synthetic import make_speech
from repro_torch.distributed import steps as S
from repro_torch.models import transformer as T
from repro_torch.wire.session import OctopusServer

K = 256                                  # codebook size = the LM's vocab
N_CLIPS, FRAMES, CHANNELS = 256, 256, 16
PRETRAIN_STEPS, PRETRAIN_BATCH = 100, 16


def tokenizer_config() -> DVQAEConfig:
    return DVQAEConfig(kind="speech", in_channels=CHANNELS, hidden=32,
                       latent_dim=16, codebook_size=K, n_res_blocks=1)


def backbone_config(small: bool):
    base = smoke_config("qwen3_0_6b")
    if small:
        return base.replace(vocab_size=K)
    return base.replace(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                        head_dim=64, d_ff=2048, vocab_size=K,
                        tie_embeddings=True)


def gather_codes(g: torch.Generator, seed: int, device):
    """Pretrain the tokenizer and transmit the clips -> ((N_CLIPS, 64)
    int32 codes on ``device``, the payload)."""
    clips = make_speech(g, N_CLIPS, frames=FRAMES, channels=CHANNELS)
    srv = OctopusServer.init(seed, tokenizer_config(), device=device)
    srv.pretrain(g, clips.x, steps=PRETRAIN_STEPS, batch=PRETRAIN_BATCH)
    payload = srv.deploy().transmit(clips.x)       # CodePayload uplink
    return payload.unpack()[0], payload


def run(*, steps: int = 200, batch: int = 8, small: bool = False,
        seed: int = 0, device=None, wrap=None) -> dict:
    """Gather the codes, then train the backbone for ``steps`` steps ->
    the codes, the uplink bytes, the backbone config, every step's loss
    (0-d tensors on the device) and the final state. ``wrap``, if given,
    takes the train step (``build_train_step``) and returns the function
    to call in its place (e.g. one that times it)."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    codes, payload = gather_codes(g, seed, dev)
    print(f"gathered {tuple(codes.shape)} code sequences "
          f"({payload.nbytes:,} bytes transmitted)")

    cfg = backbone_config(small)
    print(f"backbone: {cfg.param_count() / 1e6:.1f}M params")
    seq = codes.shape[1]
    tcfg = TrainConfig(learning_rate=3e-4, total_steps=steps,
                       warmup_steps=max(1, steps // 10))
    step_fn = S.build_train_step(cfg, tcfg)
    if wrap is not None:
        step_fn = wrap(step_fn)
    state = S.init_train_state(T.init_lm(
        torch.Generator(dev).manual_seed(seed), cfg, device=dev))
    losses, t0 = [], time.time()
    for i in range(steps):
        sel = torch.randint(0, codes.shape[0], (batch,), generator=g)
        state, loss = step_fn(state, {"tokens": codes[sel.to(dev)]})
        losses.append(loss)
        if i % 20 == 0 or i == steps - 1:
            print(f"step {i:4d} loss {float(loss):.4f} "
                  f"({batch * seq * (i + 1) / (time.time() - t0):,.0f} "
                  f"tok/s)")
    print("LM-on-codes training done.")
    return {"codes": codes, "uplink_bytes": payload.nbytes, "cfg": cfg,
            "losses": losses, "state": state}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    return run(steps=args.steps, batch=args.batch, small=args.small,
               seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
