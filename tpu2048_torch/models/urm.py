"""GameURM — the recurrent transformer actor-critic (counterpart of
``tpu2048/models/urm.py``: ``URMConfig``, ``init``, ``apply`` and
``param_labels``).

The 16 board cells are tokens. A stem (Linear(3->h, no bias) + LayerNorm +
SiLU) embeds each cell's (exponent, row/3, col/3); the hidden state starts
from the learned ``init_hidden`` and, for ``num_loops`` recurrent loops,
gets the embeddings added and runs the stack of blocks (non-causal
multi-head attention, then a SwiGLU with a depthwise short conv, each
followed by a post-add parameter-free RMSNorm). The first
``num_truncated_loops`` run without gradient (truncated backprop). The mean
over the cells feeds the action head (4 logits) and the value head.

Parameters carry the JAX tree's names (``blocks.0.qkv.w``, ``init_hidden``
of shape (1, 16, h), ``blocks.0.dwconv.w`` of shape (inter, k)), so
``train.checkpoint.state_dict_from_arrays`` carries a checkpoint across
unchanged. A fresh model is initialised as ``urm.init`` does it, from the
caller's generator, with both heads zeroed. In train mode, dropout acts on
the post-softmax attention weights with masks from the generator passed to
``forward``; in eval mode it is a no-op.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .. import NUM_ACTIONS, NUM_CELLS
from .initializers import conv1d_depthwise_default_init, truncated_normal, zero_head
from .layers import LayerNorm, Linear, dropout, rms_norm

INIT_HIDDEN_STD = 0.02


@dataclass(frozen=True)
class URMConfig:
    """The model configuration a checkpoint's manifest stores."""

    hidden_dim: int = 64
    num_layers: int = 2
    num_heads: int = 4
    expansion: float = 2.67
    dropout: float = 0.1
    num_loops: int = 4
    num_truncated_loops: int = 1
    conv_kernel: int = 2
    rms_norm_eps: float = 1e-5

    @property
    def inter(self) -> int:
        """SwiGLU intermediate width: 2/3 of expansion, rounded up to a
        multiple of 8."""
        inter = round(self.expansion * self.hidden_dim * 2 / 3)
        return ((inter + 7) // 8) * 8

    def to_dict(self) -> dict:
        return {
            "hidden_dim": self.hidden_dim,
            "num_layers": self.num_layers,
            "num_heads": self.num_heads,
            "expansion": self.expansion,
            "dropout": self.dropout,
            "num_loops": self.num_loops,
            "num_truncated_loops": self.num_truncated_loops,
            "conv_kernel": self.conv_kernel,
            "rms_norm_eps": self.rms_norm_eps,
        }


class DepthwiseConv1d(nn.Module):
    """Weights of the depthwise conv: ``w`` (channels, k) and bias ``b``,
    initialised as torch's Conv1d (``conv1d_depthwise_default_init``)."""

    def __init__(self, channels: int, k: int, generator: torch.Generator | None = None):
        super().__init__()
        p = conv1d_depthwise_default_init(channels, k, generator)
        self.w = nn.Parameter(p["w"])
        self.b = nn.Parameter(p["b"])


class GameURM(nn.Module):
    """inputs (B, 48) -> (action_logits (B, 4), value (B, 1)).

    Weights are drawn from ``generator`` in the JAX ``init``'s order (each
    block's qkv, o, gate_up, dwconv and down; the stem; ``init_hidden``; the
    action and value heads); ``zero_heads`` then zeroes both heads."""

    def __init__(self, config: URMConfig, zero_heads: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.config = config
        h, inter = config.hidden_dim, config.inter
        blocks = nn.ModuleList(nn.ModuleDict({
            "qkv": Linear(h, 3 * h, bias=False, generator=generator),
            "o": Linear(h, h, bias=False, generator=generator),
            "gate_up": Linear(h, 2 * inter, bias=False, generator=generator),
            "dwconv": DepthwiseConv1d(inter, config.conv_kernel, generator),
            "down": Linear(inter, h, bias=False, generator=generator),
        }) for _ in range(config.num_layers))
        self.stem = nn.ModuleDict({"lin": Linear(3, h, bias=False, generator=generator),
                                   "ln": LayerNorm(h)})
        self.blocks = blocks
        self.init_hidden = nn.Parameter(INIT_HIDDEN_STD * truncated_normal(
            (1, NUM_CELLS, h), -100.0, 100.0, generator))
        self.action_head = Linear(h, NUM_ACTIONS, generator=generator)
        self.value_head = Linear(h, 1, generator=generator)
        if zero_heads:
            with torch.no_grad():
                for head in (self.action_head, self.value_head):
                    for name, value in zero_head(dict(head.named_parameters())).items():
                        getattr(head, name).copy_(value)

    def _attention(self, p: nn.ModuleDict, x: torch.Tensor,
                   generator: torch.Generator | None = None) -> torch.Tensor:
        """Non-causal multi-head attention over the 16 cells; dropout acts on
        the post-softmax weights."""
        b, length, h = x.shape
        nh = self.config.num_heads
        hd = h // nh
        qkv = p["qkv"](x).reshape(b, length, 3, nh, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (B, nh, L, hd)
        attn = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        w = dropout(torch.softmax(attn, dim=-1), self.config.dropout, generator,
                    self.training)
        out = torch.matmul(w, v).transpose(1, 2).reshape(b, length, h)
        return p["o"](out)

    def _conv_swiglu(self, p: nn.ModuleDict, x: torch.Tensor) -> torch.Tensor:
        """silu(gate)*up -> depthwise conv1d over the cells (kernel k, padding
        k//2 on both sides, trimmed to the 16 cells) -> silu -> down."""
        inter, k = self.config.inter, self.config.conv_kernel
        gate, up = p["gate_up"](x).split(inter, dim=-1)
        h = F.silu(gate) * up  # (B, L, inter)
        pad = k // 2
        length = h.shape[1]
        hp = F.pad(h, (0, 0, pad, pad))
        out_len = length + 2 * pad - k + 1
        w = p["dwconv"].w  # (inter, k)
        conv = hp[:, 0:out_len] * w[:, 0]
        for j in range(1, k):
            conv = conv + hp[:, j:j + out_len] * w[:, j]
        conv = conv[:, :length] + p["dwconv"].b
        return p["down"](F.silu(conv))

    def _block(self, p: nn.ModuleDict, x: torch.Tensor,
               generator: torch.Generator | None = None) -> torch.Tensor:
        eps = self.config.rms_norm_eps
        x = rms_norm(x + self._attention(p, x, generator), eps)
        return rms_norm(x + self._conv_swiglu(p, x), eps)

    def _loop(self, hidden: torch.Tensor, emb: torch.Tensor, generator) -> torch.Tensor:
        hidden = hidden + emb
        for p in self.blocks:
            hidden = self._block(p, hidden, generator)
        return hidden

    def forward(self, inputs: torch.Tensor,
                generator: torch.Generator | None = None) -> tuple:
        if inputs.dim() == 1:
            inputs = inputs[None]
        b = inputs.shape[0]
        x = inputs.reshape(b, NUM_CELLS, 3).to(torch.float32)
        emb = F.silu(self.stem["ln"](self.stem["lin"](x)))
        hidden = self.init_hidden.expand(b, NUM_CELLS, self.config.hidden_dim)
        truncated = self.config.num_truncated_loops
        with torch.no_grad():
            for _ in range(truncated):
                hidden = self._loop(hidden, emb, generator)
        for _ in range(self.config.num_loops - truncated):
            hidden = self._loop(hidden, emb, generator)
        pooled = hidden.mean(1)
        return self.action_head(pooled), self.value_head(pooled)


def param_labels(model: nn.Module) -> dict:
    """Optimizer routing labels by parameter name, as
    ``tpu2048/models/urm.py::param_labels`` gives them: {muon|adamw} x
    {value|other}. Strictly 2-D weights (the depthwise conv's (inter, k)
    included) go to Muon; the 3-D ``init_hidden``, the biases and the norms
    to AdamW; the value head has its own learning rate."""
    return {name: ("muon" if p.dim() == 2 else "adamw")
            + ("_value" if name.startswith("value_head") else "_other")
            for name, p in model.named_parameters()}
