"""Reward assembly, returns-to-go, streaming normalisation and the advantage
(counterpart of ``tpu2048/algo/advantage.py``), over (T, N) tensors.

The reference's quirks stay:

 * Only raw points and two PBRS potentials (monotonicity, emptiness) enter
   the reward; the other documented weights are accepted and inert.
 * Normalisation uses bias-corrected EMA moments with ``max(1-beta^step,
   eps)``, and the batch is normalised with the OLD moments before its
   statistics are folded into them.
 * Advantage = normalised return-to-go - predicted value (the value head
   lives in the normalised space; no GAE).

The returns are a backward loop over T on the tensors' device: one fused
multiply-add per step (the JAX package's parallel suffix scan is an
optimisation for XLA; the two agree to float32 rounding). Scalars that depend
only on the step (the bias correction) are computed on the host in float32,
so nothing here waits for the device.

Data-parallel ranks pass their ``group`` (``parallel/mesh.py``; the JAX
package's ``axis_name``): the batch moments are then global, each rank's
sums added over the ranks, the mean before the second-pass variance.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..parallel.mesh import DataGroup, all_sum

EPS = 1e-8


@dataclass(frozen=True)
class RewardWeights:
    """The nine documented weights and the win bonus. Only ``points``,
    ``monotonicity`` and ``emptiness`` affect the reward."""

    points: float = 0.0
    smoothness: float = 0.0
    max_tile: float = 0.0
    corner: float = 0.0
    adjacency: float = 0.0
    chain: float = 0.0
    monotonicity: float = 0.0
    emptiness: float = 0.0
    topological: float = 0.0
    win_bonus: float = 0.0


class RtgMoments(NamedTuple):
    """Streaming moments of the return-to-go: 0-d float32 tensors."""

    mu: torch.Tensor  # EMA of E[G]
    m2: torch.Tensor  # EMA of E[G^2]
    first_moment: torch.Tensor  # kept equal to mu, as in the reference

    @staticmethod
    def initial(device=None) -> "RtgMoments":
        def scalar(v):
            return torch.full((), v, dtype=torch.float32, device=device)
        return RtgMoments(scalar(0.0), scalar(1.0), scalar(0.0))


def step_rewards(points, mono_before, mono_after, empt_before, empt_after,
                 weights: RewardWeights, gamma: float) -> torch.Tensor:
    """reward = w_points*points + w_mono*(gamma*mono_after - mono_before)
    + w_empt*(gamma*empt_after - empt_before), float32."""
    f = lambda x: x.to(torch.float32)  # noqa: E731
    r = weights.points * f(points)
    r = r + weights.monotonicity * (gamma * f(mono_after) - f(mono_before))
    return r + weights.emptiness * (gamma * f(empt_after) - f(empt_before))


def _backward_affine(a: torch.Tensor, b: torch.Tensor,
                     g_next: torch.Tensor) -> torch.Tensor:
    """G_t = b_t + a_t * G_{t+1} for t = T-1 .. 0, with G_T = ``g_next``."""
    G = torch.empty_like(b)
    for t in range(b.shape[0] - 1, -1, -1):
        g_next = torch.addcmul(b[t], a[t], g_next, out=G[t])
    return G


def returns_to_go(rewards: torch.Tensor, valid: torch.Tensor,
                  gamma: float) -> torch.Tensor:
    """Discounted backward accumulation per env, G_t = r_t + gamma*G_{t+1};
    steps past the episode's end have reward 0."""
    r = torch.where(valid, rewards, 0.0)
    return _backward_affine(torch.full_like(r, gamma), r, torch.zeros_like(r[0]))


def returns_to_go_packed(rewards: torch.Tensor, done_here: torch.Tensor,
                         gamma: float, bootstrap: torch.Tensor) -> torch.Tensor:
    """Segment-aware backward accumulation for packed (auto-reset) lanes:
    G_t = r_t + gamma * (0 if the episode ended at t else G_{t+1}).
    ``bootstrap`` (N,) values the state after the last recorded step, in
    raw-return units; a lane whose last step ended its episode never reads
    it."""
    a = torch.where(done_here, 0.0, gamma).to(torch.float32)
    return _backward_affine(a, rewards.to(torch.float32), bootstrap)


def corrected_mu_std(moments: RtgMoments, rtg_beta: float, rtg_step: int) -> tuple:
    """Bias-corrected (mu, std) of the streaming moments: the scale the
    critic's normalised predictions live in. ``rtg_step`` is the 1-indexed
    train step."""
    f32 = np.float32
    correction = float(max(f32(1.0) - f32(rtg_beta) ** f32(max(rtg_step, 1)), f32(EPS)))
    mu_c = moments.mu / correction
    m2_c = moments.m2 / correction
    var = torch.clamp(m2_c - mu_c.square(), min=EPS)
    return mu_c, var.sqrt()


def normalize_rtg(G: torch.Tensor, valid: torch.Tensor, moments: RtgMoments,
                  rtg_beta: float, rtg_step: int, group: DataGroup | None = None) -> tuple:
    """Normalise with the bias-corrected OLD moments, then fold the batch's
    statistics (over every rank of ``group``) into them. Returns (G_norm,
    new_moments, batch_mean, batch_var)."""
    w = valid.to(torch.float32)
    w_sum, gw_sum = all_sum(group, w.sum(), (G * w).sum())
    n = w_sum.clamp(min=1.0)
    batch_mean = gw_sum / n
    (sq_sum,) = all_sum(group, ((G - batch_mean).square() * w).sum())
    batch_var = sq_sum / n

    mu_c, std = corrected_mu_std(moments, rtg_beta, rtg_step)
    G_norm = (G - mu_c) / (std + EPS)

    new_mu = rtg_beta * moments.mu + (1.0 - rtg_beta) * batch_mean
    new_m2 = rtg_beta * moments.m2 + (1.0 - rtg_beta) * (batch_var + batch_mean.square())
    return G_norm, RtgMoments(new_mu, new_m2, new_mu), batch_mean, batch_var


def _finish(reward, G_raw, valid, value_pred, moments, rtg_beta, rtg_step, group) -> dict:
    G_norm, new_moments, batch_mean, batch_var = normalize_rtg(
        G_raw, valid, moments, rtg_beta, rtg_step, group)
    return dict(reward=reward, G_raw=G_raw, G_norm=G_norm,
                advantage=G_norm - value_pred, new_moments=new_moments,
                batch_mean=batch_mean, batch_var=batch_var)


def compute(traj_points, mono_b, mono_a, empt_b, empt_a, value_pred, valid,
            weights: RewardWeights, gamma: float, moments: RtgMoments,
            rtg_beta: float, rtg_step: int, group: DataGroup | None = None) -> dict:
    """The advantage pipeline over (T, N) episodes: a dict of reward,
    G_raw, G_norm, advantage (each (T, N)), new_moments, batch_mean and
    batch_var; the moments global over ``group``'s ranks."""
    reward = step_rewards(traj_points, mono_b, mono_a, empt_b, empt_a, weights, gamma)
    reward = torch.where(valid, reward, 0.0)
    G_raw = returns_to_go(reward, valid, gamma)
    return _finish(reward, G_raw, valid, value_pred, moments, rtg_beta, rtg_step, group)


def compute_packed(traj_points, mono_b, mono_a, empt_b, empt_a, value_pred,
                   valid, done_here, boot_value, weights: RewardWeights,
                   gamma: float, moments: RtgMoments, rtg_beta: float,
                   rtg_step: int, group: DataGroup | None = None) -> dict:
    """The pipeline for packed (auto-reset) chunks: the backward pass resets
    at episode ends, and the episode cut at the chunk's end is bootstrapped
    with the critic's value, taken to raw-return units with the same OLD
    bias-corrected moments that then normalise the batch."""
    reward = step_rewards(traj_points, mono_b, mono_a, empt_b, empt_a, weights, gamma)
    reward = torch.where(valid, reward, 0.0)
    mu_c, std = corrected_mu_std(moments, rtg_beta, rtg_step)
    boot_raw = mu_c + (std + EPS) * boot_value
    G_raw = returns_to_go_packed(reward, done_here, gamma, boot_raw)
    return _finish(reward, G_raw, valid, value_pred, moments, rtg_beta, rtg_step, group)
