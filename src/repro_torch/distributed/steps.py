"""The LM's serving steps on one device.

Port of ``repro.distributed.steps``' ``build_prefill_step`` and
``build_serve_step``. The reference builds each for a (data, model) mesh
with sharding specs and hands it to ``jit``; the port runs on one card
with no mesh (sharding is ROADMAP Queue 1's distribution item), so each
step is a plain function.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


@torch.no_grad()
def prefill_step(params, cfg: ModelConfig, tokens: torch.Tensor
                 ) -> torch.Tensor:
    """Full-sequence forward of (B, T) tokens -> (B, V) logits of the last
    position. The reference computes (B, T, V) logits and keeps the last
    column; the head works per position, so the port applies it to the
    last position only and never holds the (B, T, V) array."""
    hidden = T.hidden_states(params, cfg, tokens)
    return T._lm_head(params, cfg, hidden[:, -1])


@torch.no_grad()
def serve_step(params, cfg: ModelConfig, token: torch.Tensor, caches,
               index):
    """One greedy decode step: (B, 1) token at position ``index`` ->
    ((B, 1) int32 argmax of the next-token logits, caches updated in
    place)."""
    logits, caches = T.decode_step(params, cfg, token, caches, index)
    next_tok = logits[:, -1, :].argmax(dim=-1).to(torch.int32)
    return next_tok[:, None], caches
