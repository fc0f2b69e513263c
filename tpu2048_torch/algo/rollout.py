"""The game loops: the evaluation loop ``play`` (N games to the end, greedy,
sampled or by expectimax search) and the two rollouts that training runs,
``rollout`` (exact episodes) and ``rollout_packed`` (auto-reset lanes, with
the best-episode recorder of ``algo/capture.py``).

``play`` is the counterpart of the eval part of
``tpu2048/algo/rollout.py::rollout`` and of
``tpu2048/algo/search.py::search_rollout`` (whose loop has the same alive,
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
sampled actions have theirs. Neither loop runs under autograd.
"""

from __future__ import annotations

import sys
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..env import engine, heuristics
from ..models.encoding import encode_boards
from . import capture
from .search import BF16Leaves, SearchCoefs, expectimax_scores


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


# ---------------------------------------------------------------------------
# Exact-episodes rollout for training: counterpart of ``Trajectory`` and the
# policy path of ``rollout`` in ``tpu2048/algo/rollout.py``. N games from
# fresh boards, each to its end or ``max_steps`` moves, every step recorded
# into (T, N) buffers; the loop stops when no game is alive.
# ---------------------------------------------------------------------------


class Trajectory(NamedTuple):
    """(T, N, ...) step records and (N,) episode summaries, under the JAX
    package's names. A record is 0 where ``valid`` is False."""

    board_before: torch.Tensor  # (T, N, 4, 4) int8
    board_after: torch.Tensor  # (T, N, 4, 4) int8 (after the spawn)
    action: torch.Tensor  # (T, N) int8, the action taken
    target_action: torch.Tensor  # (T, N) int8: the expert's argmax, else == action
    target_probs: torch.Tensor  # (T, N, 4) float32 expert's soft target, else one-hot
    logprobs: torch.Tensor  # (T, N, 4) float32
    action_mask: torch.Tensor  # (T, N, 4) bool, True = invalid
    value_pred: torch.Tensor  # (T, N) float32
    entropy: torch.Tensor  # (T, N) float32
    points: torch.Tensor  # (T, N) int32
    preview: torch.Tensor  # (T, N, 4) int32
    max_created: torch.Tensor  # (T, N) int8
    mono_before: torch.Tensor  # (T, N) int32
    mono_after: torch.Tensor  # (T, N) int32 (0 on the terminal step)
    empt_before: torch.Tensor  # (T, N) int32
    empt_after: torch.Tensor  # (T, N) int32 (0 on the terminal step)
    valid: torch.Tensor  # (T, N) bool, the step was played
    done_here: torch.Tensor  # (T, N) bool, the step ended the game
    final_board: torch.Tensor  # (N, 4, 4) int8
    total_points: torch.Tensor  # (N,) int32
    num_moves: torch.Tensor  # (N,) int32
    ended: torch.Tensor  # (N,) bool, ended naturally (not cut by max_steps)
    steps_executed: int  # trips of the loop

    @property
    def total_steps(self) -> torch.Tensor:
        """The reference's count: its 1-indexed step counter skips the
        terminal move, so a game that ended reports len(moves) - 1."""
        return self.num_moves - self.ended.to(torch.int32)


_RECORDS = dict(
    board_before=((4, 4), torch.int8), board_after=((4, 4), torch.int8),
    action=((), torch.int8), target_action=((), torch.int8),
    target_probs=((4,), torch.float32), logprobs=((4,), torch.float32),
    action_mask=((4,), torch.bool), value_pred=((), torch.float32),
    entropy=((), torch.float32), points=((), torch.int32),
    preview=((4,), torch.int32), max_created=((), torch.int8),
    mono_before=((), torch.int32), mono_after=((), torch.int32),
    empt_before=((), torch.int32), empt_after=((), torch.int32),
    valid=((), torch.bool), done_here=((), torch.bool))


@torch.no_grad()
def rollout(model, num_envs: int, max_steps: int, *,
            action_generator: torch.Generator | None = None,
            env_generator: torch.Generator | None = None,
            greedy: bool = False, expert_depth: int = 0,
            expert_coefs: SearchCoefs | None = None, expert_mix: float = 1.0,
            expert_tau: float = 0.0, expert_model=None, expert_bf16: bool = False,
            boards: torch.Tensor | None = None,
            actions: torch.Tensor | None = None,
            spawns: torch.Tensor | None = None) -> Trajectory:
    """Play ``num_envs`` games from fresh boards to their ends (or
    ``max_steps`` moves), recording every step.

    The fresh boards and the spawns come from ``env_generator``, sampled
    actions from ``action_generator`` (``greedy`` takes the masked argmax).
    A test replays another engine's rollout instead: ``boards`` (N, 4, 4),
    ``actions`` (T, N) and ``spawns`` (T, 2, N) (``engine.spawn_tile``
    draws). One merge launch a trip (``engine.step`` hands back the next
    boards' moves); the loop reads ``alive.any()`` once a trip, to stop when
    every game has ended.

    Expert iteration (``expert_depth > 0``): every trip, the
    ``expert_depth``-ply ``expectimax_scores`` of all N boards under
    ``expert_coefs`` (default ``SearchCoefs()``), with the trip's own moves,
    by ``expert_model`` (a frozen teacher in eval mode; default the policy
    itself), wrapped in :class:`BF16Leaves` under ``expert_bf16`` unless it
    already is. ``target_action`` is the scores' first argmax;
    ``target_probs`` is ``softmax(scores / (sigma * expert_tau))`` with the
    illegal entries zeroed (a row with no legal move all zeros) when
    ``expert_tau > 0``, else its one-hot. The first ``round(expert_mix *
    N)`` envs take ``target_action``, the others the policy's sample (or
    ``actions``); with no policy env, no action is drawn. The policy's
    logprobs, entropy and value are recorded as without an expert."""
    if model.training:
        raise ValueError("rollout runs the policy in eval mode")
    teacher = None
    if expert_depth > 0:
        teacher = model if expert_model is None else expert_model
        if teacher.training:
            raise ValueError("the expert's model runs in eval mode")
        if expert_bf16 and not isinstance(teacher, BF16Leaves):
            teacher = BF16Leaves(teacher)
        coefs = SearchCoefs() if expert_coefs is None else expert_coefs
        # Python's round (half to even), as the reference rounds.
        n_expert = int(round(expert_mix * num_envs))
    n, cap = num_envs, max_steps
    device = next(model.parameters()).device
    if boards is None:
        boards = engine.reset(n, device, generator=env_generator)
    moves = engine.all_moves(boards)
    buf = {k: torch.zeros((cap, n) + shape, dtype=dtype, device=device)
           for k, (shape, dtype) in _RECORDS.items()}
    alive = torch.ones(n, dtype=torch.bool, device=device)
    total_points = torch.zeros(n, dtype=torch.int32, device=device)
    num_moves = torch.zeros_like(total_points)
    ended = torch.zeros_like(alive)
    final_board = boards.to(torch.int8)
    t = 0
    while t < cap and bool(alive.any()):
        invalid = moves.action_mask
        logits, value = model(encode_boards(boards))
        masked, logprobs, entropy = masked_policy(logits, invalid)
        if teacher is not None:
            scores = expectimax_scores(teacher, boards, moves, coefs, expert_depth)
            target = scores.argmax(-1)
            if expert_tau > 0:
                z = scores / (coefs.sigma * expert_tau)
                z = z.masked_fill(invalid.all(-1, keepdim=True), 0.0)
                target_probs = torch.softmax(z, dim=-1).masked_fill(invalid, 0.0)
            else:
                target_probs = F.one_hot(target, 4)
            if n_expert >= n:
                action = target
            else:
                sampled = (actions[t].long() if actions is not None else torch.multinomial(
                    logprobs.exp(), 1, generator=action_generator)[:, 0])
                action = torch.where(torch.arange(n, device=device) < n_expert, target,
                                     sampled)
        else:
            if actions is not None:
                action = actions[t].long()
            elif greedy:
                action = masked.argmax(-1)
            else:
                action = torch.multinomial(logprobs.exp(), 1,
                                           generator=action_generator)[:, 0]
            target, target_probs = action, F.one_hot(action, 4)
        mono_b, empt_b = heuristics.monotonicity(boards), heuristics.emptiness(boards)
        draws = (spawns[t] if spawns is not None
                 else engine.spawn_draws((n,), env_generator, device))
        res = engine.step(boards, action, draws, moves=moves)
        # The "after" potentials are taken before the spawn and are 0 on the
        # terminal step (the reference's quirk).
        sel = action[None, :, None, None].expand(1, n, 4, 4)
        moved = torch.gather(moves.boards, 0, sel)[0]
        done = res.done
        # Written for every lane; a lane's steps after its end are zeroed
        # below with ``valid``, as the JAX loop writes only alive lanes.
        for k, v in (
                ("board_before", boards), ("board_after", res.board),
                ("action", action), ("target_action", target),
                ("target_probs", target_probs), ("logprobs", logprobs),
                ("action_mask", invalid), ("value_pred", value[..., 0]),
                ("entropy", entropy), ("points", res.reward),
                ("preview", moves.preview_rewards), ("max_created", res.max_created),
                ("mono_before", mono_b),
                ("mono_after", torch.where(done, 0, heuristics.monotonicity(moved))),
                ("empt_before", empt_b),
                ("empt_after", torch.where(done, 0, heuristics.emptiness(moved))),
                ("valid", alive), ("done_here", done)):
            buf[k][t] = v
        total_points += torch.where(alive, res.reward, 0)
        num_moves += alive.to(torch.int32)
        ended |= done & alive
        final_board = torch.where(alive[:, None, None], res.board.to(torch.int8),
                                  final_board)
        alive = alive & ~done
        boards, moves = res.board, res.moves
        t += 1
    valid = buf["valid"]
    for k, v in buf.items():
        if k != "valid":
            mask = valid.reshape(valid.shape + (1,) * (v.dim() - 2))
            buf[k] = torch.where(mask, v, torch.zeros((), dtype=v.dtype, device=device))
    return Trajectory(**buf, final_board=final_board, total_points=total_points,
                      num_moves=num_moves, ended=ended, steps_executed=t)


# ---------------------------------------------------------------------------
# Packed (auto-reset) rollout for training: counterpart of ``EnvCarry``,
# ``init_env_carry``, ``PackedTrajectory`` and ``rollout_packed`` in
# ``tpu2048/algo/rollout.py``. ``lanes`` persistent games advance exactly
# ``num_steps`` steps per chunk; a game that ends is replaced by a fresh
# board in the same step, and the lanes' state carries over to the next
# chunk, so every recorded step is a real move. The episode cut at the end
# of a chunk is valued by the critic (``boot_value``) in the advantage stage.
# ---------------------------------------------------------------------------


class EnvCarry(NamedTuple):
    """The lanes' state between chunks."""

    boards: torch.Tensor  # (N, 4, 4) int32 live boards
    env_key: np.ndarray  # (2,) uint32 seed material of the lanes' spawns
    ep_points: torch.Tensor  # (N,) int32 score of the current episode so far
    ep_moves: torch.Tensor  # (N,) int32 moves of the current episode so far


def init_env_carry(env_key: np.ndarray, num_lanes: int, device,
                   generator: torch.Generator) -> EnvCarry:
    """Fresh boards for ``num_lanes`` lanes, spawned from ``generator``."""
    zeros = torch.zeros(num_lanes, dtype=torch.int32, device=device)
    return EnvCarry(engine.reset(num_lanes, device, generator=generator),
                    np.asarray(env_key, np.uint32), zeros, zeros.clone())


class PackedTrajectory(NamedTuple):
    """(T, N, ...) records of a packed chunk, under the JAX package's names.
    The episode fields are completion records: nonzero only where the step
    ended an episode."""

    board_before: torch.Tensor  # (T, N, 4, 4) int8
    board_after: torch.Tensor  # (T, N, 4, 4) int8 (after the spawn, before a reset)
    action: torch.Tensor  # (T, N) int8
    target_action: torch.Tensor  # (T, N) int8 (== action)
    target_probs: torch.Tensor  # (T, N, 4) float32 one-hot of the action
    logprobs: torch.Tensor  # (T, N, 4) float32
    action_mask: torch.Tensor  # (T, N, 4) bool, True = invalid
    value_pred: torch.Tensor  # (T, N) float32
    entropy: torch.Tensor  # (T, N) float32
    points: torch.Tensor  # (T, N) int32
    preview: torch.Tensor  # (T, N, 4) int32
    max_created: torch.Tensor  # (T, N) int8
    mono_before: torch.Tensor  # (T, N) int32
    mono_after: torch.Tensor  # (T, N) int32 (0 on terminal steps)
    empt_before: torch.Tensor  # (T, N) int32
    empt_after: torch.Tensor  # (T, N) int32 (0 on terminal steps)
    valid: torch.Tensor  # (T, N) bool, all True
    done_here: torch.Tensor  # (T, N) bool, the step ended an episode
    ep_start: torch.Tensor  # (T, N) bool, the step began an episode
    ep_score: torch.Tensor  # (T, N) int32 completed episode's points
    ep_len: torch.Tensor  # (T, N) int32 completed episode's moves
    ep_tile: torch.Tensor  # (T, N) int32 completed episode's max tile value
    boot_value: torch.Tensor  # (N,) float32 V(carry-out boards), critic units
    steps_executed: int


@torch.no_grad()
def rollout_packed(model, carry: EnvCarry, num_steps: int, *,
                   action_generator: torch.Generator | None = None,
                   env_generator: torch.Generator | None = None,
                   actions: torch.Tensor | None = None,
                   spawns: torch.Tensor | None = None,
                   resets: torch.Tensor | None = None,
                   recorder: capture.EpisodeRecorder | None = None) -> tuple:
    """Step every lane ``num_steps`` times with auto-reset; returns
    (PackedTrajectory, the next chunk's EnvCarry), and the updated
    ``recorder`` third when one is given (``algo/capture.py``: each trip is
    recorded, and the best completed episode kept across chunks).

    Actions are sampled from the masked policy with ``action_generator``,
    spawns and fresh boards drawn from ``env_generator``. A test replays
    another engine's chunk instead: ``actions`` (T, N), ``spawns`` (T, 2, N)
    (``engine.spawn_tile`` draws) and ``resets`` (T, N, 4, 4), the board each
    lane restarts from after step t if that step ends its game. Each step
    merges twice (``all_moves`` of the boards and, inside ``engine.step``,
    of the next boards), as the reference's chunk does; the loop reads
    nothing back to the host."""
    if model.training:
        raise ValueError("rollout_packed runs the policy in eval mode")
    boards, ep_points, ep_moves = carry.boards, carry.ep_points, carry.ep_moves
    n, device = boards.shape[0], boards.device
    recs = {k: [] for k in PackedTrajectory._fields[:-2]}
    valid = torch.ones(n, dtype=torch.bool, device=device)
    for t in range(num_steps):
        moves = engine.all_moves(boards)
        invalid = moves.action_mask
        logits, value = model(encode_boards(boards))
        _, logprobs, entropy = masked_policy(logits, invalid)
        if actions is not None:
            action = actions[t].long()
        else:
            action = torch.multinomial(logprobs.exp(), 1,
                                       generator=action_generator)[:, 0]
        mono_b, empt_b = heuristics.monotonicity(boards), heuristics.emptiness(boards)
        draws = (spawns[t] if spawns is not None
                 else engine.spawn_draws((n,), env_generator, device))
        res = engine.step(boards, action, draws, moves=moves)
        # The "after" potentials are taken before the spawn and are 0 on a
        # terminal step (the reference's quirk).
        sel = action[None, :, None, None].expand(1, n, 4, 4)
        moved = torch.gather(moves.boards, 0, sel)[0]
        done = res.done
        mono_a = torch.where(done, 0, heuristics.monotonicity(moved))
        empt_a = torch.where(done, 0, heuristics.emptiness(moved))
        ep_points_new = ep_points + res.reward
        ep_moves_new = ep_moves + 1
        for k, v in (
                ("board_before", boards.to(torch.int8)),
                ("board_after", res.board.to(torch.int8)),
                ("action", action.to(torch.int8)),
                ("target_action", action.to(torch.int8)),
                ("target_probs", F.one_hot(action, 4).to(torch.float32)),
                ("logprobs", logprobs), ("action_mask", invalid),
                ("value_pred", value[..., 0]), ("entropy", entropy),
                ("points", res.reward), ("preview", moves.preview_rewards),
                ("max_created", res.max_created.to(torch.int8)),
                ("mono_before", mono_b), ("mono_after", mono_a),
                ("empt_before", empt_b), ("empt_after", empt_a),
                ("valid", valid), ("done_here", done),
                ("ep_start", ep_moves_new == 1),
                ("ep_score", torch.where(done, ep_points_new, 0)),
                ("ep_len", torch.where(done, ep_moves_new, 0)),
                ("ep_tile", torch.where(done, engine.max_tile_value(res.board), 0))):
            recs[k].append(v)
        if recorder is not None:
            recorder = capture.record_step(
                recorder, ep_moves=ep_moves, board_before=boards,
                board_after=res.board, action=action, points=res.reward,
                entropy=entropy, done=done, ep_points_new=ep_points_new,
                ep_moves_new=ep_moves_new)
        fresh = (resets[t] if resets is not None
                 else engine.reset(n, device, generator=env_generator))
        boards = torch.where(done[:, None, None], fresh, res.board)
        ep_points = torch.where(done, 0, ep_points_new)
        ep_moves = torch.where(done, 0, ep_moves_new)
    # The critic's value of the carry-out boards, in its own (normalised)
    # units; a lane whose last step was terminal never reads it.
    _, boot = model(encode_boards(boards))
    traj = PackedTrajectory(**{k: torch.stack(v) for k, v in recs.items()},
                            boot_value=boot[..., 0], steps_executed=num_steps)
    carry_out = EnvCarry(boards, carry.env_key, ep_points, ep_moves)
    return (traj, carry_out) if recorder is None else (traj, carry_out, recorder)
