"""The batched 2048 engine on torch tensors.

Counterpart of ``tpu2048/env/engine.py``. Boards are ``(...B, 4, 4)`` int32
exponent tensors; :func:`all_moves` evaluates the slide+merge in all four
directions at once (on CUDA through the hand-written kernel, on the CPU
through its plain version), which yields legality, the reward preview and
the moved boards in one pass.

Randomness is explicit: a spawn consumes two uniform draws per board, a
``(2, ...B)`` float tensor ``(u_cell, u_exp)``. :func:`spawn_draws` makes them
from a ``torch.Generator``; a test can instead inject draws that replay
another engine's spawns exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import GRID_SIZE, NUM_CELLS
from ..ops import merge
from ..ops.merge import merge_lines_left  # noqa: F401  (engine API)

# Tile-spawn rule of the reference: 90% exponent 1, 10% exponent 2.
SPAWN_P_TWO = 0.9


class MoveSet(NamedTuple):
    """Results of moving in every direction, for a batch of boards.

    boards:      (4, ...B, 4, 4) post-move (pre-spawn) boards, indexed by dir
    scores:      (4, ...B) merge points per direction
    max_created: (4, ...B) max exponent created per direction
    legal:       (4, ...B) bool, move changes the board
    """

    boards: torch.Tensor
    scores: torch.Tensor
    max_created: torch.Tensor
    legal: torch.Tensor

    @property
    def action_mask(self) -> torch.Tensor:
        """(...B, 4) bool, True = INVALID (the reference's mask convention)."""
        return torch.logical_not(torch.movedim(self.legal, 0, -1))

    @property
    def any_legal(self) -> torch.Tensor:
        """(...B,) bool — some move is left."""
        return self.legal.any(dim=0)

    @property
    def preview_rewards(self) -> torch.Tensor:
        """(...B, 4) int32 merge points per direction (0 where illegal)."""
        return torch.movedim(self.scores, 0, -1)


def all_moves(boards: torch.Tensor) -> MoveSet:
    """Slide+merge in all four directions. ``boards``: (...B, 4, 4) int32.

    A CUDA tensor goes to the CUDA kernel (``ops/merge.merge4_cuda``), a CPU
    tensor to its plain version; there is no other path and no fallback."""
    batch = boards.shape[:-2]
    flat = boards.reshape(-1, GRID_SIZE, GRID_SIZE).contiguous()
    if flat.is_cuda:
        fields = merge.merge4_cuda(flat)
    elif flat.device.type == "cpu":
        fields = merge.merge4_plain(flat)
    else:
        raise ValueError(f"all_moves: no merge for device {flat.device}")
    out, scores, max_created, legal = fields
    return MoveSet(out.reshape((4,) + batch + (GRID_SIZE, GRID_SIZE)),
                   scores.reshape((4,) + batch),
                   max_created.reshape((4,) + batch),
                   legal.reshape((4,) + batch))


def spawn_draws(batch_shape: tuple, generator: torch.Generator,
                device: torch.device) -> torch.Tensor:
    """(2, *batch_shape) uniform [0, 1) draws for one spawn per board."""
    return torch.rand((2,) + tuple(batch_shape), generator=generator,
                      device=device)


def spawn_tile(boards: torch.Tensor, draws: torch.Tensor) -> torch.Tensor:
    """Add a tile to a uniform-random empty cell of each board.

    ``draws[0]`` picks the cell: the k-th empty cell in row-major order with
    k = floor(u * n_empty). ``draws[1]`` picks the exponent: 1 if u < 0.9,
    else 2. Boards with no empty cell are returned unchanged."""
    batch = boards.shape[:-2]
    flat = boards.reshape(batch + (NUM_CELLS,))
    empty = flat == 0
    n_empty = empty.sum(-1)
    k = torch.minimum((draws[0] * n_empty).long(), (n_empty - 1).clamp(min=0))
    rank = torch.cumsum(empty, -1) - 1
    target = empty & (rank == k.unsqueeze(-1))
    exp = torch.where(draws[1] < SPAWN_P_TWO, 1, 2).to(boards.dtype)
    new_flat = flat + target.to(boards.dtype) * exp.unsqueeze(-1)
    return new_flat.reshape(boards.shape)


def reset(batch_size: int, device: torch.device,
          generator: torch.Generator | None = None,
          draws: torch.Tensor | None = None) -> torch.Tensor:
    """``batch_size`` fresh boards with two spawned tiles each.

    Randomness comes from ``generator`` or, when given, from ``draws``, a
    (2, 2, batch_size) tensor: one spawn's draws per tile."""
    if draws is None:
        if generator is None:
            raise ValueError("reset needs a generator or draws")
        draws = torch.stack([spawn_draws((batch_size,), generator, device)
                             for _ in range(2)])
    boards = torch.zeros((batch_size, GRID_SIZE, GRID_SIZE), dtype=torch.int32,
                         device=device)
    return spawn_tile(spawn_tile(boards, draws[0]), draws[1])


class StepResult(NamedTuple):
    board: torch.Tensor  # (...B, 4, 4) post-spawn board
    reward: torch.Tensor  # (...B,) int32 merge points (0 if invalid move)
    done: torch.Tensor  # (...B,) bool — no legal move remains
    invalid: torch.Tensor  # (...B,) bool — chosen direction was illegal
    max_created: torch.Tensor  # (...B,) int32 max exponent created
    moves: MoveSet  # the next state's MoveSet (board after spawn)


def step(boards: torch.Tensor, action: torch.Tensor, draws: torch.Tensor,
         moves: MoveSet | None = None) -> StepResult:
    """One transition for every board.

    An invalid action leaves the board unchanged, scores 0 and spawns
    nothing. A valid one applies the move and spawns a tile from ``draws``
    (see :func:`spawn_tile`). ``moves`` may pass in ``all_moves(boards)``;
    the next state's MoveSet is returned, so a loop merges each board once
    per step."""
    if moves is None:
        moves = all_moves(boards)
    batch = boards.shape[:-2]
    a = torch.broadcast_to(torch.as_tensor(action, device=boards.device),
                           batch).long()
    sel = a[None, ..., None, None].expand((1,) + batch + (GRID_SIZE, GRID_SIZE))
    moved = torch.gather(moves.boards, 0, sel)[0]
    reward = torch.gather(moves.scores, 0, a[None])[0]
    max_created = torch.gather(moves.max_created, 0, a[None])[0]
    legal = torch.gather(moves.legal, 0, a[None])[0]

    zero = torch.zeros_like(reward)
    reward = torch.where(legal, reward, zero)
    max_created = torch.where(legal, max_created, zero)
    spawned = spawn_tile(moved, draws)
    # The tile spawns only after a successful move.
    new_board = torch.where(legal[..., None, None], spawned, boards)

    next_moves = all_moves(new_board)
    done = torch.logical_not(next_moves.any_legal)
    return StepResult(new_board, reward, done, torch.logical_not(legal),
                      max_created, next_moves)


def board_scores(boards: torch.Tensor) -> torch.Tensor:
    """Sum of tile values per board."""
    vals = torch.where(boards > 0, torch.ones_like(boards) << boards,
                       torch.zeros_like(boards))
    return vals.sum((-1, -2), dtype=torch.int32)


def max_tile_value(boards: torch.Tensor) -> torch.Tensor:
    """Largest tile value (2**max_exp, 0 for an empty board)."""
    m = boards.amax((-1, -2))
    return torch.where(m > 0, torch.ones_like(m) << m, torch.zeros_like(m))
