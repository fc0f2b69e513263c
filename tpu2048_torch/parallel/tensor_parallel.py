"""Tensor-parallel ``GameMLP`` (counterpart of
``tpu2048/parallel/tensor_parallel.py``), with DTensor over the 'model' axis
of a ``DeviceMesh`` (``mesh.make_mesh``).

The 2048 models are far too small for tensor parallelism to pay; this is the
reference's demonstration that the models shard, in its column/row layout:

  stem and block weights  (h, in)  Shard(0)  column-parallel
  LayerNorm gains/biases  (h,)     Shard(0)  (on the hidden dim)
  head weights            (4|1, h) Shard(1)  row-parallel (summed)
  head biases                      Replicate

DTensor's sharding propagation inserts the collectives, as GSPMD does for
the JAX package; :func:`tp_forward` hands back replicated outputs.
"""

from __future__ import annotations

import torch
from torch.func import functional_call


def mlp_param_placements(model) -> dict:
    """{parameter name: DTensor placement} of a ``GameMLP``."""
    from torch.distributed.tensor import Replicate, Shard

    def place(name: str, p: torch.Tensor):
        if name.startswith(("action_head", "value_head")):
            return Shard(1) if p.dim() == 2 else Replicate()
        return Shard(0) if p.dim() in (1, 2) else Replicate()

    return {n: place(n, p) for n, p in model.named_parameters()}


def shard_mlp(model, mesh) -> dict:
    """The model's parameters as DTensors over ``mesh['model']``, placed by
    :func:`mlp_param_placements` (every rank passes the same model)."""
    from torch.distributed.tensor import distribute_tensor

    tp = mesh["model"]
    return {n: distribute_tensor(p.detach(), tp, [place])
            for (n, p), place in zip(model.named_parameters(),
                                     mlp_param_placements(model).values())}


def tp_forward(model, mesh):
    """``forward(sharded_params, inputs) -> (logits, value)``: the model's
    forward on DTensor parameters from :func:`shard_mlp`, the inputs
    replicated in, the outputs replicated out (plain tensors)."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    tp = mesh["model"]

    def forward(sharded: dict, inputs: torch.Tensor) -> tuple:
        x = distribute_tensor(inputs.to(torch.float32), tp, [Replicate()])
        with torch.no_grad():
            outs = functional_call(model, sharded, (x,))
        return tuple(o.redistribute(tp, [Replicate()]).to_local() for o in outs)

    return forward
