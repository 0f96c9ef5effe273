"""The LM's train, prefill and serve steps on one device.

Port of ``repro.distributed.steps``' ``build_train_step``,
``build_prefill_step`` and ``build_serve_step``. The reference builds each
for a (data, model) mesh with sharding specs and hands it to ``jit``; the
port runs on one card with no mesh (sharding is ROADMAP Queue 1's
distribution item), so each step is a plain function. An encoder-decoder's
prefill and serve steps take ``enc_out``, which the caller computes once
with ``models.transformer.encode_audio`` under ``torch.no_grad()``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     leaves)
from repro_torch.optim.schedules import warmup_cosine


class TrainState(NamedTuple):
    """The reference's train state: LM parameters (``init_lm``'s tree),
    their AdamW moments (lists in the order of :func:`leaves`) and the
    step count (a Python int)."""
    params: dict
    opt: AdamWState
    step: int


def init_train_state(params: dict) -> TrainState:
    """Step 0 with zero moments; the parameters are made leaves that
    require grad."""
    for p in leaves(params):
        p.requires_grad_(True)
    return TrainState(params=params, opt=adamw_init(params), step=0)


def build_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """-> ``train_step(state, batch) -> (state, loss)``, the reference's
    step on one device: ``lm_loss`` (remat as ``tcfg.remat``; with the MTP
    head's term where ``cfg.use_mtp``, deepseek-v3) and its gradient, the
    learning rate ``warmup_cosine(state.step)``, one AdamW update with
    ``tcfg``'s betas, weight decay and global-norm clip. The parameters
    (leaves that require grad, as :func:`init_train_state` and
    ``checkpoint.restore`` give them) and moments are updated in place (the
    reference returns new arrays); ``batch["tokens"]`` is (B, T) int on the
    parameters' device; the loss is a 0-d tensor there, detached.

    An encoder-decoder (whisper) also takes ``batch["frames"]`` (B,
    n_audio_frames, d_model): the loss is ``lm_loss`` against
    ``encode_audio`` of them, as the reference's step computes it, and the
    gradient reaches the encoder through cross-attention's keys and
    values (the encoder itself is not rematerialised, as in the
    reference)."""

    def train_step(state: TrainState, batch):
        flat = leaves(state.params)
        enc = (T.encode_audio(state.params, cfg, batch["frames"])
               if cfg.is_encoder_decoder else None)
        loss = T.lm_loss(state.params, cfg, batch["tokens"], enc_out=enc,
                         remat=tcfg.remat)
        # an expert no token reached has no gradient: zero, as jax.grad
        grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                    materialize_grads=True)
        lr = warmup_cosine(state.step, base_lr=tcfg.learning_rate,
                           warmup_steps=tcfg.warmup_steps,
                           total_steps=tcfg.total_steps)
        params, opt = adamw_update(state.params, grads, state.opt,
                                   lr=float(lr), b1=tcfg.b1, b2=tcfg.b2,
                                   weight_decay=tcfg.weight_decay,
                                   grad_clip=tcfg.grad_clip)
        return TrainState(params=params, opt=opt,
                          step=state.step + 1), loss.detach()

    return train_step


@torch.no_grad()
def prefill_step(params, cfg: ModelConfig, tokens: torch.Tensor, *,
                 enc_out=None) -> torch.Tensor:
    """Full-sequence forward of (B, T) tokens -> (B, V) logits of the last
    position. The reference computes (B, T, V) logits and keeps the last
    column; the head works per position, so the port applies it to the
    last position only and never holds the (B, T, V) array. ``enc_out``:
    an encoder-decoder's encoder output (the reference's step encodes
    ``batch["frames"]`` itself)."""
    hidden = T.hidden_states(params, cfg, tokens, enc_out=enc_out)
    return T._lm_head(params, cfg, hidden[:, -1])


@torch.no_grad()
def serve_step(params, cfg: ModelConfig, token: torch.Tensor, caches,
               index, enc_out=None):
    """One greedy decode step: (B, 1) token at position ``index`` ->
    ((B, 1) int32 argmax of the next-token logits, caches updated in
    place). ``enc_out``: an encoder-decoder's encoder output."""
    logits, caches = T.decode_step(params, cfg, token, caches, index,
                                   enc_out=enc_out)
    next_tok = logits[:, -1, :].argmax(dim=-1).to(torch.int32)
    return next_tok[:, None], caches
