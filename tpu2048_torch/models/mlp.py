"""GameMLP — the residual MLP actor-critic (counterpart of
``tpu2048/models/mlp.py``).

Stem Linear(48->h, no bias) + LayerNorm + ReLU; ``num_layers`` residual
blocks ``x + Dropout(ReLU(LN(Linear(x, no bias))))``; action head
Linear(h->4) and value head Linear(h->1), both biased. ``decouple_critic``
detaches the value head's features from the trunk. Dropout is kept for
parity of the configuration; it is inactive in eval mode, the only mode the
port runs so far.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .. import NUM_ACTIONS
from .encoding import INPUT_DIM
from .layers import LayerNorm, Linear


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

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.lin = Linear(in_dim, dim, bias=False)
        self.ln = LayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.ln(self.lin(x)))


class GameMLP(nn.Module):
    """inputs (..., 48) -> (action_logits (..., 4), value (..., 1))."""

    def __init__(self, config: MLPConfig):
        super().__init__()
        self.config = config
        h = config.hidden_dim
        self.stem = LinNormReLU(INPUT_DIM, h)
        self.blocks = nn.ModuleList(LinNormReLU(h, h)
                                    for _ in range(config.num_layers))
        self.dropout = nn.Dropout(config.dropout)
        self.action_head = Linear(h, NUM_ACTIONS)
        self.value_head = Linear(h, 1)

    def forward(self, inputs: torch.Tensor) -> tuple:
        x = self.stem(inputs.to(torch.float32))
        for block in self.blocks:
            x = x + self.dropout(block(x))
        logits = self.action_head(x)
        features = x.detach() if self.config.decouple_critic else x
        return logits, self.value_head(features)
