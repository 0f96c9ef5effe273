"""LR schedules: linear warmup into cosine or constant decay.

Port of ``repro.optim.schedules``. Computed in float32 on the CPU, as the
reference computes them on a float32 step, from a Python int or a 0-d
tensor step; each returns a 0-d float32 tensor.
"""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).detach().to("cpu", torch.float32)


def warmup_cosine(step, *, base_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    step = _step(step)
    warm = base_lr * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5
                     * (1.0 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)


def warmup_constant(step, *, base_lr: float,
                    warmup_steps: int) -> torch.Tensor:
    step = _step(step)
    return base_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
