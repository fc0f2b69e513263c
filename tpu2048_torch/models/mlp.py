"""GameMLP — the residual MLP actor-critic (counterpart of
``tpu2048/models/mlp.py``).

Stem Linear(48->h, no bias) + LayerNorm + ReLU; ``num_layers`` residual
blocks ``x + Dropout(ReLU(LN(Linear(x, no bias))))``; action head
Linear(h->4) and value head Linear(h->1), both biased. ``decouple_critic``
detaches the value head's features from the trunk. A fresh model zeroes both
heads, as ``mlp.init(zero_heads=True)`` does, unless asked not to. Dropout is
live only in train mode, with masks drawn from the caller's generator.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .. import NUM_ACTIONS
from .encoding import INPUT_DIM
from .initializers import zero_head
from .layers import LayerNorm, Linear, dropout


@dataclass(frozen=True)
class MLPConfig:
    """The model configuration a checkpoint's manifest stores."""

    hidden_dim: int = 64
    num_layers: int = 2
    dropout: float = 0.1
    decouple_critic: bool = False

    def to_dict(self) -> dict:
        return {
            "hidden_dim": self.hidden_dim,
            "num_layers": self.num_layers,
            "dropout": self.dropout,
            "decouple_critic": self.decouple_critic,
        }


class LinNormReLU(nn.Module):
    """``ReLU(LN(Linear(x)))`` without a bias: the stem and each block."""

    def __init__(self, in_dim: int, dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.lin = Linear(in_dim, dim, bias=False, generator=generator)
        self.ln = LayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.ln(self.lin(x)))


class GameMLP(nn.Module):
    """inputs (..., 48) -> (action_logits (..., 4), value (..., 1)).

    Weights are drawn from ``generator`` (stem, blocks, action head, value
    head, in that order); ``zero_heads`` then zeroes both heads."""

    def __init__(self, config: MLPConfig, zero_heads: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.config = config
        h = config.hidden_dim
        self.stem = LinNormReLU(INPUT_DIM, h, generator)
        self.blocks = nn.ModuleList(LinNormReLU(h, h, generator)
                                    for _ in range(config.num_layers))
        self.action_head = Linear(h, NUM_ACTIONS, generator=generator)
        self.value_head = Linear(h, 1, generator=generator)
        if zero_heads:
            with torch.no_grad():
                for head in (self.action_head, self.value_head):
                    for name, value in zero_head(dict(head.named_parameters())).items():
                        getattr(head, name).copy_(value)

    def forward(self, inputs: torch.Tensor,
                generator: torch.Generator | None = None) -> tuple:
        x = self.stem(inputs.to(torch.float32))
        for block in self.blocks:
            x = x + dropout(block(x), self.config.dropout, generator, self.training)
        logits = self.action_head(x)
        features = x.detach() if self.config.decouple_critic else x
        return logits, self.value_head(features)


def param_labels(model: nn.Module) -> dict:
    """Optimizer routing labels by parameter name, as
    ``tpu2048/models/mlp.py::param_labels`` gives them: {muon|adamw} x
    {value|other}. 2-D weights (both heads' included) go to Muon, 1-D ones
    to AdamW; the value head has its own learning rate."""
    return {name: ("muon" if p.dim() >= 2 else "adamw")
            + ("_value" if name.startswith("value_head") else "_other")
            for name, p in model.named_parameters()}
