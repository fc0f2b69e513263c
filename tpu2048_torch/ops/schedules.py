"""The learning-rate schedule (counterpart of ``tpu2048/ops/schedules.py``):
transformers' cosine with warmup. It ticks once per train step, not per
minibatch, so every minibatch of train step t uses multiplier(t). Computed
on the host in float32, as the JAX package computes it on the device."""

from __future__ import annotations

import numpy as np


def cosine_with_warmup(step: int, warmup_steps: int, total_steps: int,
                       num_cycles: float = 0.5) -> np.float32:
    """Linear 0 -> 1 over the warmup, then 0.5 * (1 + cos(pi * 2 *
    num_cycles * progress)) down to 0, as a float32."""
    f32 = np.float32
    step = f32(step)
    if step < warmup_steps:
        return step / f32(max(1.0, warmup_steps))
    progress = (step - f32(warmup_steps)) / f32(max(1.0, total_steps - warmup_steps))
    cos = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi * num_cycles * 2.0) * progress))
    return max(f32(0.0), cos)
