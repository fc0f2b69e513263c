"""Best-episode capture for packed (auto-reset) rollouts (counterpart of
``tpu2048/algo/capture.py``).

A packed lane holds many episodes, and a good one spans chunk boundaries, so
no chunk's (T, N) records contain it. The recorder rides the packed rollout
on the device:

  * every lane writes its current step into its own episode buffer at
    position ``ep_moves`` (one indexed put per field and trip);
  * when episodes complete, the best completion of the trip is compared with
    the best episode committed so far and, if it scores more, its lane
    buffer is copied into the ``best_*`` fields (a selection, not a host
    branch);
  * the trainer reads the ``best_*`` fields to the host only on a new high
    or at print cadence. A trip reads nothing back.

An episode longer than ``cap`` moves keeps overwriting its last slot: the
recorded prefix and the final move stay exact, and ``best_true_len`` >
``best_len`` marks the truncation.

Memory: lanes x cap x 41 B (two int8 boards, an int8 action, int32 points,
float32 entropy): 54 MB at 512 lanes and 430 MB at 4,096, cap 2560.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class EpisodeRecorder(NamedTuple):
    """Device tensors carried across packed chunks."""

    # Per-lane in-flight episode buffers, write position = ep_moves.
    lane_before: torch.Tensor  # (N, cap, 4, 4) int8, the board before each move
    lane_after: torch.Tensor  # (N, cap, 4, 4) int8, the board after move and spawn
    lane_action: torch.Tensor  # (N, cap) int8
    lane_points: torch.Tensor  # (N, cap) int32
    lane_entropy: torch.Tensor  # (N, cap) float32
    # The best completed episode committed so far.
    best_before: torch.Tensor  # (cap, 4, 4) int8
    best_after: torch.Tensor  # (cap, 4, 4) int8
    best_action: torch.Tensor  # (cap,) int8
    best_points: torch.Tensor  # (cap,) int32
    best_entropy: torch.Tensor  # (cap,) float32
    best_score: torch.Tensor  # () int32, the episode's total points
    best_len: torch.Tensor  # () int32, moves stored (= min(true_len, cap))
    best_true_len: torch.Tensor  # () int32, the episode's length
    # Lanes whose in-flight episode began before this recorder existed (the
    # lanes' state came from a checkpoint, which does not keep the lane
    # buffers): their first completion would commit a zeroed prefix, so they
    # do not commit until their next reset.
    lane_tainted: torch.Tensor  # (N,) bool


BEST_FIELDS = ("best_before", "best_after", "best_action", "best_points",
               "best_entropy", "best_score", "best_len", "best_true_len")


def init_recorder(num_lanes: int, cap: int, device=None) -> EpisodeRecorder:
    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return EpisodeRecorder(
        lane_before=z((num_lanes, cap, 4, 4), torch.int8),
        lane_after=z((num_lanes, cap, 4, 4), torch.int8),
        lane_action=z((num_lanes, cap), torch.int8),
        lane_points=z((num_lanes, cap), torch.int32),
        lane_entropy=z((num_lanes, cap), torch.float32),
        best_before=z((cap, 4, 4), torch.int8),
        best_after=z((cap, 4, 4), torch.int8),
        best_action=z((cap,), torch.int8),
        best_points=z((cap,), torch.int32),
        best_entropy=z((cap,), torch.float32),
        best_score=z((), torch.int32),
        best_len=z((), torch.int32),
        best_true_len=z((), torch.int32),
        lane_tainted=z((num_lanes,), torch.bool),
    )


def mark_resumed(rec: EpisodeRecorder, ep_moves: torch.Tensor) -> EpisodeRecorder:
    """Taint the lanes restored mid-episode (ep_moves > 0): their played
    prefix is not in the lane buffers, so their first completion must not
    commit."""
    return rec._replace(lane_tainted=ep_moves > 0)


def _take(buf: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``buf[index]`` for a 0-d index tensor, on the device (indexing with a
    0-d tensor would read it to the host)."""
    return torch.index_select(buf, 0, index.reshape(1))[0]


def record_step(rec: EpisodeRecorder, *, ep_moves, board_before, board_after,
                action, points, entropy, done, ep_points_new,
                ep_moves_new) -> EpisodeRecorder:
    """One packed trip: write every lane's move, commit the trip's best
    completion if it beats the committed episode. The lane buffers are
    written in place; the returned recorder holds them and the new
    ``best_*`` fields and taint.

    ``ep_moves`` is the lanes' move count before the trip (the write
    position); ``ep_points_new``/``ep_moves_new`` include the trip."""
    n, cap = rec.lane_action.shape
    lanes = torch.arange(n, device=ep_moves.device)
    pos = torch.clamp(ep_moves, max=cap - 1).long()
    for buf, val in ((rec.lane_before, board_before), (rec.lane_after, board_after),
                     (rec.lane_action, action), (rec.lane_points, points),
                     (rec.lane_entropy, entropy)):
        buf.index_put_((lanes, pos), val.to(buf.dtype))

    # The best completion of this trip against the committed best. A tainted
    # lane never commits; the first lane of the highest score is the one.
    cand_scores = torch.where(done & ~rec.lane_tainted, ep_points_new, -1)
    top = cand_scores.amax()
    cand = torch.where(cand_scores == top, lanes, n).amin()
    take = top > rec.best_score
    cand_len = _take(ep_moves_new, cand)

    def sel(lane_buf, best):
        return torch.where(take, _take(lane_buf, cand), best)

    return rec._replace(
        best_before=sel(rec.lane_before, rec.best_before),
        best_after=sel(rec.lane_after, rec.best_after),
        best_action=sel(rec.lane_action, rec.best_action),
        best_points=sel(rec.lane_points, rec.best_points),
        best_entropy=sel(rec.lane_entropy, rec.best_entropy),
        best_score=torch.where(take, top, rec.best_score),
        best_len=torch.where(take, torch.clamp(cand_len, max=cap), rec.best_len),
        best_true_len=torch.where(take, cand_len, rec.best_true_len),
        lane_tainted=rec.lane_tainted & ~done,
    )
