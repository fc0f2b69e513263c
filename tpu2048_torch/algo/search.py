"""Value-guided expectimax search (counterpart of ``tpu2048/algo/search.py``).

For every board and every legal action, all 32 tile spawns (16 cells x
{exponent 1 with p=.9, exponent 2 with p=.1}) of the merged board are
enumerated, and the action is scored by the exact Bellman backup of the
trained objective:

    score(a) = points*pts(a) + gamma * E_spawn[ 1[alive] * (phi(m_a) + SV(child)) ]

``phi`` is the PBRS potential of the merged board ``m_a`` (before the spawn),
``SV`` the shaped state value of a spawn child: exactly 0 when the child has
no legal move, ``sigma*V(child) + mu`` from the critic at the leaves, and
the child's own expectimax value above them. Every board of the tree goes
through ``engine.all_moves``, so on CUDA every level runs the merge kernel.

The recursion is eager: where the JAX package sweeps the 32 spawn slots of a
chance node with ``jax.lax.map``, this module loops over them in Python, each
slot one batched subproblem over all M merged boards, so the peak memory is
that of one slot, as in the reference.

``sigma`` and ``mu`` may be Python floats (a finished checkpoint's
calibration) or 0-d tensors on the boards' device (the live moments of
expert iteration, :func:`coefs_from_moments`), which the host never reads.
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import torch
from torch import nn

from .. import NUM_CELLS
from ..env import engine
from ..env import heuristics as H
from ..models.encoding import encode_boards
from .advantage import corrected_mu_std

NUM_SPAWNS = 2 * NUM_CELLS  # 16 cells x {exp 1 (p=.9), exp 2 (p=.1)}
SPAWN_P_ONE = engine.SPAWN_P_TWO  # probability of exponent 1 (a "2" tile)


class SearchCoefs(NamedTuple):
    """Coefficients tying search scores to the trained objective. The
    defaults are the params-only fallback: pure normalized-EV search (critic
    leaves, terminal masking, no shaping terms)."""

    points: float = 0.0   # points weight of the trained reward
    mono: float = 0.0     # PBRS monotonicity weight (potential term)
    empt: float = 0.0     # PBRS emptiness weight (potential term)
    sigma: float = 1.0    # RTG std: denormalizes the critic
    mu: float = 0.0       # RTG mean
    gamma: float = 0.99


def coefs_from_moments(moments, rtg_step: int, points: float, mono: float,
                       empt: float, gamma: float, rtg_beta: float) -> SearchCoefs:
    """SearchCoefs from the live streaming RTG moments: the bias-corrected
    mean and std (variance floored at 1e-8) the learner normalises with at
    1-indexed step ``rtg_step`` (``advantage.corrected_mu_std``), as 0-d
    tensors on the moments' device, so no host sync."""
    mu, sigma = corrected_mu_std(moments, rtg_beta, rtg_step)
    return SearchCoefs(points=points, mono=mono, empt=empt, sigma=sigma, mu=mu,
                       gamma=gamma)


class BF16Leaves(nn.Module):
    """``model`` as the JAX package's bf16 search leaves compute it: its
    input and floating parameters rounded to bfloat16, every operation in
    float32 (the reference casts the input to bf16, its ``apply`` casts it
    back to f32, and f32 x bf16 products promote to f32). A copy: later
    changes to ``model`` do not reach it."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = copy.deepcopy(model)
        with torch.no_grad():
            for q in self.model.parameters():
                if q.is_floating_point():
                    q.copy_(q.to(torch.bfloat16).to(q.dtype))

    def forward(self, inputs: torch.Tensor) -> tuple:
        return self.model(inputs.to(torch.bfloat16).to(torch.float32))


def potential(boards: torch.Tensor, coefs: SearchCoefs) -> torch.Tensor:
    """phi(s) of the trained PBRS shaping over (..., 4, 4) boards, float32."""
    phi = coefs.mono * H.monotonicity(boards).to(torch.float32)
    return phi + coefs.empt * H.emptiness(boards).to(torch.float32)


def _chance_ev(model, merged: torch.Tensor, coefs: SearchCoefs, depth: int,
               prune_k: int) -> torch.Tensor:
    """(M,) expected shaped child value of each merged (post-move, pre-spawn)
    board over the exact 32-way spawn distribution:

        E_spawn[ 1[child alive] * (phi(merged) + SV(child)) ]

    ``depth`` counts the max-node plies left below the chance node: 0 values
    live children with the denormalized critic, >= 1 by their own
    ``depth``-ply state value, one spawn slot at a time."""
    m = merged.shape[0]
    flat = merged.reshape(m, NUM_CELLS)
    empty = flat == 0  # (M, 16)
    n_empty = empty.sum(-1).clamp(min=1)  # (M,)

    # Candidate children: cell c set to exponent e on each merged board,
    # (M, 16 cells, 2 exps, 16); only those whose cell was empty count.
    # The constants are made on the device: a tensor copied from the host
    # would make the host wait for the device at every chance node.
    cell_hot = torch.eye(NUM_CELLS, dtype=flat.dtype, device=flat.device)
    exps = torch.arange(1, 3, dtype=flat.dtype, device=flat.device)
    cand = flat[:, None, None, :] + cell_hot[None, :, None, :] * exps[None, None, :, None]
    probs = torch.where(exps == 1, SPAWN_P_ONE, 1.0 - SPAWN_P_ONE)  # float32
    weights = torch.where(empty[:, :, None], probs / n_empty[:, None, None], 0.0)

    children = cand.reshape(m, NUM_SPAWNS, 4, 4)
    if depth <= 0:
        # A child with no legal move is game over: its future return is
        # exactly 0, whatever the critic (never trained on dead boards) says.
        flat_children = children.reshape(m * NUM_SPAWNS, 4, 4)
        alive = engine.all_moves(flat_children).any_legal.reshape(m, NUM_SPAWNS)
        _, values = model(encode_boards(flat_children))
        sv = coefs.sigma * values.reshape(m, NUM_SPAWNS) + coefs.mu
    else:
        slots = [state_values(model, children[:, s], coefs, depth, prune_k)
                 for s in range(NUM_SPAWNS)]
        sv = torch.stack([v for v, _ in slots], dim=1)  # (M, 32)
        alive = torch.stack([a for _, a in slots], dim=1)

    phi_m = potential(merged, coefs)  # (M,)
    contrib = torch.where(alive, phi_m[:, None] + sv, 0.0)
    return (weights.reshape(m, NUM_SPAWNS) * contrib).sum(-1)


def expectimax_scores(model, boards: torch.Tensor,
                      moves: engine.MoveSet | None = None,
                      coefs: SearchCoefs = SearchCoefs(), depth: int = 1,
                      prune_k: int = 0) -> torch.Tensor:
    """(B, 4) action scores in trained-reward units (up to the
    action-independent ``-phi(boards)``); illegal actions are -inf.

    ``model(x (N, 48)) -> (logits, value)``; only the value is read.
    ``depth`` is the number of max-node plies: 1 values every live spawn
    child with the critic, d recurses d-1 more times. ``prune_k`` (0 = off)
    bounds the branching of the inner max nodes (see :func:`state_values`);
    it has no effect below depth 3, and the root's four actions are never
    pruned."""
    if moves is None:
        moves = engine.all_moves(boards)
    merged = moves.boards  # (4, B, 4, 4)
    d, b = merged.shape[0], merged.shape[1]
    ev = _chance_ev(model, merged.reshape(d * b, 4, 4), coefs, depth - 1,
                    prune_k).reshape(d, b)
    score = coefs.points * moves.scores.to(torch.float32) + coefs.gamma * ev
    score = torch.where(moves.legal, score, float("-inf"))
    return score.movedim(0, -1)


def top_k_first(scores: torch.Tensor, k: int) -> torch.Tensor:
    """(..., k) indices of the ``k`` largest entries of the last axis,
    largest first and the lower index first among equal values, as
    ``jax.lax.top_k`` orders them (``torch.topk`` promises no order among
    ties)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]


def state_values(model, boards: torch.Tensor,
                 coefs: SearchCoefs = SearchCoefs(), depth: int = 1,
                 prune_k: int = 0) -> tuple:
    """((B,) float32, (B,) bool): the exact shaped state value of each board
    by ``depth``-ply expectimax, ``max_a score(a) - phi(board)`` (comparable
    across boards), and whether it has a legal move. A board with none is
    worth exactly 0.

    ``prune_k`` in 1..3 with ``depth >= 2``: rank the actions by the 1-ply
    search and expand only the top ``prune_k`` at full depth."""
    moves = engine.all_moves(boards)
    b = boards.shape[0]
    if depth >= 2 and 0 < prune_k < 4:
        shallow = expectimax_scores(model, boards, moves, coefs, 1)
        sel = top_k_first(shallow, prune_k).T  # (k, B)
        bidx = torch.arange(b, device=boards.device)[None, :]
        sel_merged = moves.boards[sel, bidx]  # (k, B, 4, 4)
        sel_pts = moves.scores[sel, bidx].to(torch.float32)
        sel_legal = moves.legal[sel, bidx]
        ev = _chance_ev(model, sel_merged.reshape(prune_k * b, 4, 4), coefs,
                        depth - 1, prune_k).reshape(prune_k, b)
        s = coefs.points * sel_pts + coefs.gamma * ev
        s = torch.where(sel_legal, s, float("-inf"))
        v = s.amax(0) - potential(boards, coefs)
    else:
        s = expectimax_scores(model, boards, moves, coefs, depth, prune_k)
        v = s.amax(-1) - potential(boards, coefs)
    alive = moves.any_legal
    return torch.where(alive, v, 0.0), alive
