"""Batch statistics (counterpart of ``tpu2048/utils/stats.py``).

``device_stats`` reduces the chunk on its device; ``assemble_metrics``
(host) merges them with the optimizer's statistics and the EMA trackers into
the reference's metric names, quirks included:

 * ``avg_score``/``median_score`` count the augmented pseudo-episode (the
   sum of the augmented rows' points) as one more episode, while per-step
   statistics leave augmented rows out.
 * ``total_loss``/``actor_loss``/``critic_loss`` read keys the optimizer
   statistics never set, so they log as 0.

The episode statistics come from the lanes' summaries in exact-episodes
mode (``total_points`` and ``valid[0]``) and from completion records in
packed mode.

Data-parallel ranks pass their ``group`` (the JAX package's ``axis_name``):
every statistic is then global. The weighted sums are added over the ranks
(the means in one collective, then the second-pass variances in another),
the extrema maxed and minned in one, and the episode scores (with their
mask) gathered in rank order before the average and the median.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import DataGroup, all_extrema, all_sum

DSTAT_KEYS = (
    "samples", "augmented_samples", "reward_mean", "reward_var",
    "zero_reward_pct", "advantage_mean", "advantage_var", "advantage_l2",
    "adv_min", "adv_max", "G_norm_mean", "G_norm_std", "G_norm_min",
    "G_norm_max", "G_raw_std", "V_std", "A_std", "var_reduction",
    "explained_var", "avg_score", "median_score", "avg_episode_return",
)


def device_stats(traj, adv: dict, aug_valid: torch.Tensor, aug_points: torch.Tensor,
                 episode_scores: torch.Tensor | None = None,
                 episode_mask: torch.Tensor | None = None,
                 ep_start_mask: torch.Tensor | None = None,
                 group: DataGroup | None = None) -> dict:
    """0-d tensors keyed by ``DSTAT_KEYS``. ``traj``: a Trajectory or a
    PackedTrajectory; ``adv``: the dict of ``advantage.compute`` or
    ``compute_packed``; ``aug_*``: the augmented rows' validity and points.

    Packed mode passes ``episode_scores``/``episode_mask`` (flat over the
    (T, N) grid): completion records, in place of ``traj.total_points``;
    and ``ep_start_mask`` (flat): the steps that began an episode, whose
    raw return is the episode's G_0, in place of ``traj.valid[0]``.
    ``group``: the statistics over every rank's chunk."""
    w = traj.valid.to(torch.float32)
    # G_0 of each episode: the raw return of its first move.
    if ep_start_mask is not None:
        starts, g_raw = ep_start_mask, adv["G_raw"].reshape(-1)
    else:
        starts, g_raw = traj.valid[0], adv["G_raw"][0]
    ep_returns = torch.where(starts, g_raw, 0.0)
    fields = (adv["reward"], adv["advantage"], adv["G_raw"], adv["G_norm"], traj.value_pred)
    sums = all_sum(group, w.sum(), *((x * w).sum() for x in fields),
                   ((adv["reward"] == 0.0) * w).sum(), (adv["advantage"].square() * w).sum(),
                   aug_valid.sum(), ep_returns.sum(), starts.to(torch.float32).sum())
    n = sums[0].clamp(min=1.0)
    means = [s / n for s in sums[1:6]]
    sq = all_sum(group, *(((x - m).square() * w).sum() for x, m in zip(fields, means)))
    (reward_mean, adv_mean, _, fnorm_mean, _), variances = means, [s / n for s in sq]
    reward_var, adv_var, future_var, fnorm_var, v_var = variances
    zero_sum, adv_sq_sum, aug_count, ep_return_sum, n_starts = sums[6:]
    zero_reward_pct = zero_sum / n * 100.0

    # Episode scores, the augmented pseudo-episode among them. The median
    # sorts non-completions to +inf and indexes by the true count.
    aug_score = torch.where(aug_valid, aug_points, 0).sum()
    if episode_scores is not None:
        smask = torch.cat([episode_mask, episode_mask.new_ones(1)])
        scores = torch.cat([episode_scores, aug_score[None]]).to(torch.float32)
        if group is not None and group.size > 1:
            both = group.gather(torch.stack([scores, smask.to(torch.float32)], 1))
            scores, smask = both[:, 0], both[:, 1] > 0
        n_done = smask.to(torch.float32).sum().clamp(min=1.0)
        avg_score = torch.where(smask, scores, 0.0).sum() / n_done
        ordered = torch.sort(torch.where(smask, scores, float("inf"))).values
        median = ordered[torch.clamp(n_done.to(torch.int64) // 2,
                                     max=ordered.shape[0] - 1)]
        median_score = torch.where(torch.isfinite(median), median, 0.0)
    else:
        scores = torch.cat([traj.total_points, aug_score[None]]).to(torch.float32)
        if group is not None:
            scores = group.gather(scores)
        scores = torch.sort(scores).values
        n_ep = scores.shape[0]
        avg_score = scores.mean()
        median_score = (scores[n_ep // 2] if n_ep % 2 == 1
                        else (scores[n_ep // 2 - 1] + scores[n_ep // 2]) / 2.0)

    avg_episode_return = ep_return_sum / n_starts.clamp(min=1.0)

    big = 1e30
    (adv_max, g_max), (adv_min, g_min) = all_extrema(
        group, (torch.where(traj.valid, adv["advantage"], -big).max(),
                torch.where(traj.valid, adv["G_norm"], -big).max()),
        (torch.where(traj.valid, adv["advantage"], big).min(),
         torch.where(traj.valid, adv["G_norm"], big).min()))
    fnorm_std, adv_std = fnorm_var.sqrt(), adv_var.sqrt()
    zero = torch.zeros_like(fnorm_std)
    return dict(
        samples=n,
        augmented_samples=aug_count.to(torch.float32),
        reward_mean=reward_mean,
        reward_var=reward_var,
        zero_reward_pct=zero_reward_pct,
        advantage_mean=adv_mean,
        advantage_var=adv_var,
        advantage_l2=adv_sq_sum.sqrt(),
        adv_min=adv_min,
        adv_max=adv_max,
        G_norm_mean=fnorm_mean,
        G_norm_std=fnorm_std,
        G_norm_min=g_min,
        G_norm_max=g_max,
        G_raw_std=future_var.sqrt(),
        V_std=v_var.sqrt(),
        A_std=adv_std,
        var_reduction=torch.where(fnorm_std > 0, (fnorm_std - adv_std) / fnorm_std * 100.0,
                                  zero),
        explained_var=torch.where(fnorm_var > 0, 1.0 - adv_var / fnorm_var, zero),
        avg_score=avg_score,
        median_score=median_score,
        avg_episode_return=avg_episode_return,
    )


def assemble_metrics(dstats: dict, opt_stats: dict, *, highest_score,
                     ema_avg_score, ema_pct_512, ema_pct_1024, ema_pct_2048,
                     batch_pct_512, batch_pct_1024, batch_pct_2048,
                     ema_explained_var, current_beta, lr) -> dict:
    """The logged metric dict, with the reference's keys in its order."""
    return {
        "samples": int(dstats["samples"]),
        "augmented_samples": int(dstats["augmented_samples"]),
        "actor_loss": 0,  # the reference logs keys its stats never set
        "critic_loss": 0,
        "total_loss": 0,
        "policy_loss": float(opt_stats["policy_loss"]),
        "entropy_loss": float(opt_stats["entropy_loss"]),
        "value_loss": float(opt_stats["value_loss"]),
        "actor_grad_norm": 0,
        "critic_grad_norm": 0,
        "grad_norm": float(opt_stats["grad_norm"]),
        "entropy": float(opt_stats["entropy"]),
        "peak_score": highest_score,
        "avg_score": float(dstats["avg_score"]),
        "ema_avg_score": ema_avg_score,
        "median_score": float(dstats["median_score"]),
        "avg_episode_return": float(dstats["avg_episode_return"]),
        "pct_512": batch_pct_512,
        "ema_pct_512": ema_pct_512,
        "pct_1024": batch_pct_1024,
        "ema_pct_1024": ema_pct_1024,
        "pct_2048": batch_pct_2048,
        "ema_pct_2048": ema_pct_2048,
        "reward_var": float(dstats["reward_var"]),
        "reward_mean": float(dstats["reward_mean"]),
        "zero_reward_pct": float(dstats["zero_reward_pct"]),
        "advantage_mean": float(dstats["advantage_mean"]),
        "advantage_var": float(dstats["advantage_var"]),
        "advantage_l2": float(dstats["advantage_l2"]),
        "adv_min": float(dstats["adv_min"]),
        "adv_max": float(dstats["adv_max"]),
        "G_norm_mean": float(dstats["G_norm_mean"]),
        "G_norm_std": float(dstats["G_norm_std"]),
        "G_norm_min": float(dstats["G_norm_min"]),
        "G_norm_max": float(dstats["G_norm_max"]),
        "G_raw_std": float(dstats["G_raw_std"]),
        "V_std": float(dstats["V_std"]),
        "A_std": float(dstats["A_std"]),
        "var_reduction": float(dstats["var_reduction"]),
        "explained_var": float(dstats["explained_var"]),
        "ema_explained_var": ema_explained_var,
        "kl_total": float(opt_stats["kl_total"]),
        "kl_average": float(opt_stats["kl_average"]),
        "kl_max": float(opt_stats["kl_max"]),
        "actor_lr": lr,
        "critic_lr": 0,
        "current_beta": current_beta,
    }
