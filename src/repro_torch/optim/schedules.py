"""LR schedules as step -> scale functions (multiplied onto the config's
lr; port of ``repro/optim/schedules.py``). ``step`` is an integer tensor;
the scale is an f32 tensor on its device."""
from __future__ import annotations

import math

import torch


def constant():
    return lambda step: torch.ones((), dtype=torch.float32, device=step.device)


def linear_warmup(warmup: int):
    def f(step):
        s = step.to(torch.float32)
        return torch.clamp(s / max(warmup, 1), max=1.0)

    return f


def warmup_cosine(warmup: int, total: int, min_scale: float = 0.1):
    def f(step):
        s = step.to(torch.float32)
        warm = torch.clamp(s / max(warmup, 1), max=1.0)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_scale + (1 - min_scale) * 0.5 * (1 + torch.cos(math.pi * prog))
        return warm * cos

    return f


def inverse_sqrt(warmup: int):
    def f(step):
        s = torch.clamp(step.to(torch.float32), min=1.0)
        return torch.minimum(s / max(warmup, 1), torch.sqrt(warmup / s))

    return f
