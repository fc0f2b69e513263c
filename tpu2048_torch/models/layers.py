"""The layers of the model families (counterpart of
``tpu2048/models/layers.py``: ``linear``, ``layer_norm``, ``rms_norm`` and
``dropout``).

Parameters carry the JAX package's names (``w``/``b`` for a linear layer,
``g``/``b`` for a layer norm), so a module's ``state_dict`` keys are the JAX
parameter tree's key paths joined with dots.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .initializers import layer_norm_init, linear_init

LN_EPS = 1e-5  # torch LayerNorm default, as in the JAX package


class Linear(nn.Module):
    """``y = x @ w.T (+ b)`` with ``w`` of shape (out, in). Initialised as
    the reference initialises a Linear (``initializers.linear_init``):
    kaiming-uniform (relu) weight from ``generator``, zero bias."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        p = linear_init(out_dim, in_dim, bias, generator)
        self.w = nn.Parameter(p["w"])
        self.b = nn.Parameter(p["b"]) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.w, self.b)


class LayerNorm(nn.Module):
    """Layer norm over the last axis with gain ``g`` and bias ``b``."""

    def __init__(self, dim: int, eps: float = LN_EPS):
        super().__init__()
        self.eps = eps
        p = layer_norm_init(dim)
        self.g = nn.Parameter(p["g"])
        self.b = nn.Parameter(p["b"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.g, self.b, self.eps)


def rms_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Parameter-free RMSNorm over the last axis, computed in float32 and
    cast back to ``x``'s dtype."""
    xf = x.to(torch.float32)
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            training: bool) -> torch.Tensor:
    """Inverted dropout in train mode (kept values scaled by 1/(1-rate)), its
    masks drawn from ``generator``; a no-op in eval mode or at rate 0."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout > 0 in train mode needs a generator for its masks")
    keep = torch.bernoulli(torch.full_like(x, 1.0 - rate), generator=generator)
    return torch.where(keep.bool(), x / (1.0 - rate), torch.zeros_like(x))
