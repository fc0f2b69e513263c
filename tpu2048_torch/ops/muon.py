"""Muon's orthogonalisation for 2-D weights (counterpart of
``tpu2048/ops/muon.py``: ``newton_schulz`` and ``adjust_lr``).

  buf <- mu * buf + (1 - mu) * g          (EMA momentum)
  u   <- (1 - mu) * g + mu * buf          (Nesterov)
  O   <- NewtonSchulz5(u)                 (bfloat16, 5 quintic iterations)
  p   <- p * (1 - lr * wd) - adjust(lr, shape) * O

The momentum and the parameter update live in ``ops/optimizer.py``. The
bfloat16 products here are plain matmuls, as the JAX package computes them
outside any Pallas kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NS_COEFFS = (3.4445, -4.7750, 2.0315)
NS_STEPS = 5
EPS = 1e-7


def newton_schulz(g: torch.Tensor, steps: int = NS_STEPS,
                  coeffs: tuple = NS_COEFFS, eps: float = EPS) -> torch.Tensor:
    """Quintic Newton-Schulz orthogonalisation in bfloat16 of a 2-D matrix,
    or of each matrix of a (k, A, B) stack (the JAX package maps it over
    same-shape weights). Works on the transpose when A > B; returns
    bfloat16. As in the JAX package, the coefficients are rounded to
    bfloat16 and every product and sum is rounded to bfloat16."""
    a, b, c = (float(torch.tensor(k).to(torch.bfloat16)) for k in coeffs)
    x = g.to(torch.bfloat16)
    transpose = g.shape[-2] > g.shape[-1]
    if transpose:
        x = x.mT
    # The Frobenius norm as the JAX package takes it in bfloat16: products
    # rounded to bfloat16, summed in float32, the sum rounded, its root too.
    norm = (x * x).float().sum(dim=(-2, -1), keepdim=True).to(torch.bfloat16).sqrt()
    x = x / torch.clamp(norm, min=eps)
    for _ in range(steps):
        gram = x @ x.mT
        gram_update = b * gram + c * (gram @ gram)
        x = a * x + gram_update @ x
    return x.mT if transpose else x


def adjust_lr(lr, shape: tuple, adjust_lr_fn: str | None = "match_rms_adamw"):
    """The learning rate Muon applies to a (A, B) weight: ``0.2 *
    sqrt(max(A, B)) * lr`` for ``match_rms_adamw``, ``sqrt(max(1, A/B)) *
    lr`` for ``original``. A float32 ``lr`` gives a float32 result."""
    A, B = shape[0], shape[1]
    if adjust_lr_fn is None or adjust_lr_fn == "original":
        return lr * np.float32(math.sqrt(max(1.0, A / B)))
    if adjust_lr_fn == "match_rms_adamw":
        return lr * np.float32(0.2 * math.sqrt(max(A, B)))
    return lr
