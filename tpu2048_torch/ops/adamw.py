"""AdamW with decoupled weight decay (counterpart of ``tpu2048/ops/adamw.py``),
for the 1-D parameters (biases, layer-norm gains):

  m <- b1 m + (1 - b1) g;  v <- b2 v + (1 - b2) g^2
  p <- p (1 - lr wd) - lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)

on lists of tensors, updated in place with ``torch._foreach_*`` (one launch
per operation for the whole list).
"""

from __future__ import annotations

import numpy as np
import torch

ADAM_EPS = 1e-8


@torch.no_grad()
def update_(params: list, grads: list, m: list, v: list, step: int, lr, *,
            beta1: float = 0.9, beta2: float = 0.999,
            weight_decay: float = 0.01) -> None:
    """One AdamW step of ``step`` (1-indexed) on every tensor of the lists,
    in place. ``lr`` is a float32 scalar."""
    if not params:
        return
    f32, t = np.float32, np.float32(step)
    bc1, bc2 = float(f32(1.0) - f32(beta1) ** t), float(f32(1.0) - f32(beta2) ** t)
    new_m = torch._foreach_add(torch._foreach_mul(m, beta1),
                               torch._foreach_mul(grads, 1.0 - beta1))
    new_v = torch._foreach_add(torch._foreach_mul(v, beta2),
                               torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                  1.0 - beta2))
    torch._foreach_copy_(m, new_m)
    torch._foreach_copy_(v, new_v)
    num = torch._foreach_mul(torch._foreach_div(new_m, bc1), float(lr))
    den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(new_v, bc2)),
                             ADAM_EPS)
    decay = float(np.float32(1.0) - np.float32(lr) * np.float32(weight_decay))
    torch._foreach_copy_(params, torch._foreach_sub(torch._foreach_mul(params, decay),
                                                    torch._foreach_div(num, den)))
