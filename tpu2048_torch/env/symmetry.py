"""Board symmetry transforms and the matching action-space remaps
(counterpart of ``tpu2048/env/symmetry.py``).

A mirrored or rotated board is a valid training sample provided the taken
action, the action mask and the behaviour policy's logprobs are permuted the
same way (the augmentation stage, ``algo/augment.py``).

Transform ids:
  0: identity          3: rotate 90 clockwise
  1: mirror horizontal 4: rotate 180
  2: mirror vertical   5: rotate 270 clockwise
Directions 0=UP 1=DOWN 2=LEFT 3=RIGHT.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

IDENTITY, MIRROR_H, MIRROR_V, ROT90, ROT180, ROT270 = 0, 1, 2, 3, 4, 5
NUM_TRANSFORMS = 6

# action_new = ACTION_MAP[transform, action_old]: mirror horizontal swaps
# LEFT/RIGHT, mirror vertical UP/DOWN; rotating 90 clockwise maps UP->RIGHT,
# RIGHT->DOWN, DOWN->LEFT, LEFT->UP.
_R90 = np.array([3, 2, 0, 1], dtype=np.int64)
ACTION_MAP = np.stack([
    np.array([0, 1, 2, 3], dtype=np.int64),
    np.array([0, 1, 3, 2], dtype=np.int64),
    np.array([1, 0, 2, 3], dtype=np.int64),
    _R90,
    _R90[_R90],
    _R90[_R90][_R90],
])
# PERM[t, j]: the old index whose value lands at new index j (the scatter
# new[ACTION_MAP[t, i]] = old[i] written as a gather).
PERM = np.empty_like(ACTION_MAP)
for _t in range(NUM_TRANSFORMS):
    PERM[_t, ACTION_MAP[_t]] = np.arange(4)

# CELL_PERM[t, j]: the flat old cell whose value lands at flat new cell j.
_I = np.arange(16, dtype=np.int64).reshape(4, 4)
CELL_PERM = np.stack([
    _I,
    _I[:, ::-1],
    _I[::-1, :],
    np.rot90(_I, k=-1),
    np.rot90(_I, k=2),
    np.rot90(_I, k=1),
]).reshape(NUM_TRANSFORMS, 16)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> tuple:
    """(ACTION_MAP, PERM, CELL_PERM) on ``device``, copied there once: a
    host-to-device copy in the training step would synchronise the host."""
    return tuple(torch.as_tensor(t, device=device)
                 for t in (ACTION_MAP, PERM, CELL_PERM))


def transform_board(boards: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """Apply a per-board transform. ``boards``: (...B, 4, 4); ``transform``:
    (...B,) int in [0, 6). Mirror horizontal flips the columns, vertical the
    rows; rotations are clockwise."""
    flat = boards.reshape(boards.shape[:-2] + (16,))
    perm = _tables(boards.device)[2][transform.long()]
    return torch.gather(flat, -1, perm).reshape(boards.shape)


def transform_action(action: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """Remap taken-action indices under a per-sample transform (int64)."""
    return _tables(action.device)[0][transform.long(), action.long()]


def transform_action_vector(vec: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """Permute a per-action vector (a (...B, 4) mask or logprobs) so that the
    entry of direction d moves to the transformed direction."""
    perm = _tables(vec.device)[1][transform.long()]
    return torch.gather(vec, -1, perm)
