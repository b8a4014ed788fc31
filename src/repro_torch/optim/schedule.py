"""LR schedules (pure functions of the step counter), in fp32 as the JAX
package computes them."""
from __future__ import annotations

import math

import torch


def constant_schedule(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def fn(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = peak_lr * torch.clamp((step + 1) / max(1, warmup_steps),
                                     max=1.0)
        prog = torch.clamp((step - warmup_steps)
                           / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * \
            (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)
    return fn
