"""LR schedules as step -> scale functions, port of
``repro.optim.schedules``: float32 tensors on the step's device (a
Python step gives a CPU tensor)."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step)


def linear_warmup(step, warmup_steps: int) -> torch.Tensor:
    return torch.clamp((_step(step) + 1) / max(warmup_steps, 1), max=1.0)


def cosine_schedule(step, total_steps: int, warmup_steps: int = 0,
                    final_frac: float = 0.1) -> torch.Tensor:
    step = _step(step)
    warm = linear_warmup(step, warmup_steps)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
