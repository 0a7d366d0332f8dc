"""LR schedules as pure functions of the step counter, in float32 as the
reference computes them."""
from __future__ import annotations

import numpy as np

_F32 = np.float32


def linear_warmup(step, warmup_steps: int):
    return np.minimum(_F32(1.0), _F32(step + 1) / _F32(max(warmup_steps, 1)))


def cosine_schedule(step, total_steps: int, warmup_steps: int = 0,
                    final_frac: float = 0.1):
    warm = linear_warmup(step, warmup_steps)
    t = np.clip(_F32(step - warmup_steps)
                / _F32(max(total_steps - warmup_steps, 1)), _F32(0), _F32(1))
    cos = _F32(0.5) * (_F32(1) + np.cos(_F32(np.pi) * t))
    return warm * (_F32(final_frac) + (_F32(1) - _F32(final_frac)) * cos)
