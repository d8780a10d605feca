"""Learning-rate schedules: the port of ``repro.optim.schedule``, on plain
floats (the step is a host integer in the port's trainer)."""
from __future__ import annotations

import math


def warmup_constant(step, *, lr: float, warmup_steps: int):
    w = min(1.0, (step + 1) / max(warmup_steps, 1))
    return lr * w


def warmup_cosine(step, *, lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    w = min(1.0, (step + 1) / max(warmup_steps, 1))
    p = min(1.0, max(0.0, (step - warmup_steps)
                     / max(total_steps - warmup_steps, 1)))
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi * p))
    return lr * w * cos
