"""The evaluation game loop: N games to the end, greedy, sampled or by
expectimax search.

Counterpart of the eval-only part of ``tpu2048/algo/rollout.py::rollout`` and
of ``tpu2048/algo/search.py::search_rollout`` (whose loop has the same alive,
points and frozen-board rules). One trip of the loop is one step of every
game:

    all_moves (the merge kernel)  ->  action mask
    policy forward (eval mode)    ->  masked argmax or masked sample
      or expectimax_scores        ->  argmax of the search scores
    step (move + spawn)           ->  next boards and their all_moves

``step`` hands back the next state's moves, so each board is merged once per
step. Games that have ended stay as they are (no legal move, so no change)
and stop scoring. The loop stops when every game has ended or after
``max_steps`` trips. It keeps what ``run_eval`` reads, plus the actions taken.

Randomness is split as in the reference: the spawns have their own stream
(a generator, or injected draws that replay another engine's spawns), and
sampled actions have theirs.
"""

from __future__ import annotations

import sys
import time
from typing import NamedTuple

import torch

from ..env import engine
from ..models.encoding import encode_boards
from .search import expectimax_scores


class PlayResult(NamedTuple):
    total_points: torch.Tensor  # (N,) int32 merge points of each game
    final_board: torch.Tensor  # (N, 4, 4) int32 board when the game ended
    num_moves: torch.Tensor  # (N,) int32 moves played
    ended: torch.Tensor  # (N,) bool — ended naturally (not cut by max_steps)
    actions: torch.Tensor  # (steps, N) int64 action chosen at each trip
    steps: int  # trips of the loop


def masked_policy(logits: torch.Tensor, invalid_mask: torch.Tensor) -> tuple:
    """(masked_logits, logprobs, entropy): invalid logits -> -inf, logprobs
    = log_softmax of the masked logits, entropy over the legal entries. A row
    with no legal move (an ended game) gets uniform logits."""
    masked = logits.masked_fill(invalid_mask, float("-inf"))
    all_invalid = invalid_mask.all(-1, keepdim=True)
    safe = torch.where(all_invalid, torch.zeros_like(masked), masked)
    logprobs = torch.log_softmax(safe, dim=-1)
    plogp = torch.where(invalid_mask, torch.zeros_like(logprobs),
                        logprobs.exp() * logprobs)
    return safe, logprobs, -plogp.sum(-1)


@torch.inference_mode()
def play(model, boards: torch.Tensor, max_steps: int, spawns, *,
         greedy: bool, action_generator: torch.Generator | None = None,
         search: tuple | None = None) -> PlayResult:
    """Play the games that start from ``boards`` (N, 4, 4) int32.

    ``spawns`` is a ``torch.Generator`` on the boards' device, or a
    (max_steps, 2, N) tensor of spawn draws (``engine.spawn_tile``) for each
    trip. ``search`` = ``(coefs, depth, prune_k)`` takes the argmax of
    ``expectimax_scores`` (the policy head is not run) and prints a
    heartbeat to stderr every 100 trips; otherwise ``greedy`` takes the
    masked argmax, or actions are sampled from the masked policy with
    ``action_generator``."""
    n = boards.shape[0]
    moves = engine.all_moves(boards)
    alive = torch.ones(n, dtype=torch.bool, device=boards.device)
    total_points = torch.zeros(n, dtype=torch.int32, device=boards.device)
    num_moves = torch.zeros_like(total_points)
    ended = torch.zeros_like(alive)
    final_board = boards.clone()
    actions = []
    t_prev = time.perf_counter()
    for t in range(max_steps):
        if not bool(alive.any()):
            break
        if search is not None and t and t % 100 == 0:
            now = time.perf_counter()
            print(f"    [search loop] move {t}: {int(alive.sum())}/{n} alive, "
                  f"avg points so far {float(total_points.float().mean()):.0f}, "
                  f"{(now - t_prev) * 10:.0f} ms/move", file=sys.stderr, flush=True)
            t_prev = now
        if search is not None:
            coefs, depth, prune_k = search
            action = expectimax_scores(model, boards, moves, coefs, depth,
                                       prune_k).argmax(-1)
        else:
            logits, _ = model(encode_boards(boards))
            masked, logprobs, _ = masked_policy(logits, moves.action_mask)
            if greedy:
                action = masked.argmax(-1)
            else:
                action = torch.multinomial(logprobs.exp(), 1,
                                           generator=action_generator)[:, 0]
        draws = (spawns[t] if isinstance(spawns, torch.Tensor)
                 else engine.spawn_draws((n,), spawns, boards.device))
        res = engine.step(boards, action, draws, moves=moves)
        total_points += torch.where(alive, res.reward, 0)
        num_moves += alive.to(torch.int32)
        ended |= res.done & alive
        final_board = torch.where(alive[:, None, None], res.board, final_board)
        alive &= ~res.done
        boards, moves = res.board, res.moves
        actions.append(action)
    steps = len(actions)
    stacked = (torch.stack(actions) if actions
               else torch.zeros((0, n), dtype=torch.int64, device=boards.device))
    return PlayResult(total_points, final_board, num_moves, ended, stacked, steps)
