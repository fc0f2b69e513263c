"""tpu2048_torch — the PyTorch/CUDA port of tpu2048, for an NVIDIA H100.

Mirrors the module layout of ``tpu2048`` so each counterpart is easy to find:

  env/      the batched 2048 engine (merge, spawn, step) on torch tensors,
            the heuristic suite (the shaping potentials and the logging
            signals), board symmetries
  ops/      hand-written CUDA kernels (``csrc/``), their nvcc build and
            wrappers; the optimizer (Muon + AdamW) and the lr schedule
  models/   board encoding, initializers, the GameMLP and GameURM
            actor-critics as ``nn.Module``s
  algo/     the game loops (evaluation, the exact-episodes and packed
            training rollouts), the best-episode recorder, masked policy,
            expectimax search, advantage, augmentation, PPO losses and the
            learner
  parallel/ data-parallel training over torch.distributed (the process
            group and its collectives, the sharded train step, the launch
            of local ranks) and the tensor-parallel GameMLP
  train/    checkpoints (read and write), the PPO and expert trainer,
            ``evaluate`` (greedy, sampled, search; best-of play for the
            demo), the demo export, the terminal clients, the warm start
            and the CLI
  utils/    card timing, training statistics, the metric logger, the
            episode printers and viz JSON exporters, the ONNX writer
  serve.py  the HTTP policy server (policy, greedy and search modes)

Imports torch, numpy and the standard library only — never ``jax`` and never
the ``tpu2048`` package. Entry points run on ``cuda`` unless the caller asks
for ``cpu``; asking for ``cuda`` without a card raises.
"""

from __future__ import annotations

import torch

GRID_SIZE = 4
NUM_ACTIONS = 4
NUM_CELLS = GRID_SIZE * GRID_SIZE

# Direction index convention of the reference model output: 0=UP, 1=DOWN,
# 2=LEFT, 3=RIGHT.
UP, DOWN, LEFT, RIGHT = 0, 1, 2, 3
DIRECTION_NAMES = ("UP", "DOWN", "LEFT", "RIGHT")


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device for ``device``; raises if it is a CUDA device and no
    card is present (the port never falls back to the CPU by itself)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (--device cpu) to run on the CPU")
    return dev
