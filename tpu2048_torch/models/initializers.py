"""Weight initializers (counterpart of ``tpu2048/models/initializers.py``).

The reference applies ``kaiming_uniform_(nonlinearity='relu')`` to every
Linear weight and zeroes the biases; LayerNorms keep torch's defaults (gain 1,
bias 0); the URM's depthwise Conv1d keeps torch's default init and its
initial hidden state is a truncated normal (std 0.02); the training CLI
zeroes the action and value heads after init, so the first policy is uniform
over the legal moves and the first value is 0.

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


def conv1d_depthwise_default_init(channels: int, kernel: int,
                                  generator: torch.Generator | None = None) -> dict:
    """torch's default Conv1d init for a depthwise conv: the weight (channels,
    kernel) by ``kaiming_uniform_(a=sqrt(5))`` with fan_in = kernel, that is
    U(-1/sqrt(k), 1/sqrt(k)), and the bias U(-1/sqrt(k), 1/sqrt(k))."""
    bound = math.sqrt(1.0 / kernel)
    w = torch.rand((channels, kernel), generator=generator, dtype=torch.float32)
    b = torch.rand((channels,), generator=generator, dtype=torch.float32)
    return {"w": w * (2 * bound) - bound, "b": b * (2 * bound) - bound}


def truncated_normal(shape: tuple, lower: float, upper: float,
                     generator: torch.Generator | None = None) -> torch.Tensor:
    """A standard normal truncated to [lower, upper], float32, by inverting
    the CDF of a uniform draw between the bounds' CDFs, as
    ``jax.random.truncated_normal`` draws it."""
    sqrt2 = math.sqrt(2.0)
    a, b = math.erf(lower / sqrt2), math.erf(upper / sqrt2)
    u = torch.rand(shape, generator=generator, dtype=torch.float32) * (b - a) + a
    return torch.clamp(sqrt2 * torch.erfinv(u), lower, upper)


def zero_head(head: dict) -> dict:
    """A Linear head with its weight (and bias) zeroed."""
    return {k: torch.zeros_like(v) for k, v in head.items()}
