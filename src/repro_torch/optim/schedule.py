"""Learning-rate schedules, pure functions of the step counter
(``repro/optim/schedule.py``).

A step is an int or a 0-dim tensor (``PPOState.step`` on the card); the
rate comes back as a 0-dim float32 tensor on the step's device, so a
schedule read inside the update loop costs no host sync.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[torch.Tensor | int], torch.Tensor]


def _f32(step: torch.Tensor | int) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def linear_warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1) -> Schedule:
    def lr(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp(
            (step - warmup_steps) / max(total_steps - warmup_steps, 1),
            0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)

    return lr


def constant(peak_lr: float) -> Schedule:
    return lambda step: torch.full_like(_f32(step), peak_lr)


def linear_decay(peak_lr: float, total_steps: int) -> Schedule:
    """The paper's PPO schedule: 'Linearly Decreased to 0' (Table 3)."""

    def lr(step):
        frac = 1.0 - torch.clamp(_f32(step) / total_steps, 0.0, 1.0)
        return peak_lr * frac

    return lr


__all__ = ["Schedule", "constant", "linear_decay", "linear_warmup_cosine"]
