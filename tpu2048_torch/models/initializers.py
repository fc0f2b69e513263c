"""Weight initializers (counterpart of ``tpu2048/models/initializers.py``).

The reference applies ``kaiming_uniform_(nonlinearity='relu')`` to every
Linear weight and zeroes the biases; LayerNorms keep torch's defaults (gain 1,
bias 0); the training CLI zeroes the action and value heads after init, so
the first policy is uniform over the legal moves and the first value is 0.

Draws come from the caller's ``torch.Generator`` (the global RNG when none is
given) and are made on the CPU, so a seeded model is the same on every
device.
"""

from __future__ import annotations

import math

import torch


def kaiming_uniform_relu(shape: tuple, fan_in: int,
                         generator: torch.Generator | None = None) -> torch.Tensor:
    """U(-b, b) with b = sqrt(2) * sqrt(3 / fan_in) = sqrt(6 / fan_in), float32."""
    bound = math.sqrt(6.0 / fan_in)
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return u * (2 * bound) - bound


def linear_init(out_features: int, in_features: int, bias: bool = True,
                generator: torch.Generator | None = None) -> dict:
    """``{'w': (out, in)[, 'b': (out,)]}``: kaiming-relu weight, zero bias."""
    p = {"w": kaiming_uniform_relu((out_features, in_features), in_features,
                                   generator)}
    if bias:
        p["b"] = torch.zeros(out_features)
    return p


def layer_norm_init(dim: int) -> dict:
    return {"g": torch.ones(dim), "b": torch.zeros(dim)}


def zero_head(head: dict) -> dict:
    """A Linear head with its weight (and bias) zeroed."""
    return {k: torch.zeros_like(v) for k, v in head.items()}
