"""Cosine LR schedule with linear warmup (paper §4: peak 4e-4, 1k warmup);
the port of ``repro/optim/schedule.py``, computed in f32 as ``jnp`` does."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, peak_lr=4e-4, warmup=1000, total_steps=88_000,
                    final_frac=0.1) -> torch.Tensor:
    """-> the learning rate at ``step`` as a 0-dim f32 tensor (on the
    device of ``step`` when it is a tensor, else on the CPU)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = peak_lr * step / max(warmup, 1)
    t = torch.clamp((step - warmup) / max(total_steps - warmup, 1), 0, 1)
    cos = final_frac * peak_lr + (1 - final_frac) * peak_lr * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < warmup, warm, cos)
