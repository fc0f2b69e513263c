"""Warm start: a full ``train_state`` from a params-only ``best_model``
(counterpart of ``scripts/warmstart_from_best.py``).

    python -m tpu2048_torch.train.warmstart --ckpt-dir DIR [--src-dir SRC] \
        [--train-step 4500] [--gamma 0.99] [--points 0.10] [--mono 1.0] \
        [--highest-score 0] [--expert-depth 0|1|2] [--device cuda|cpu]

It loads ``best_model`` from ``--src-dir`` (default ``--ckpt-dir``), builds a
fresh optimizer state, measures the return-to-go moments from a rollout of
the loaded policy (so the run's normalisation resumes calibrated), and
writes ``train_state`` into ``--ckpt-dir`` in the JAX package's format,
pinned at ``--train-step``: both packages' trainers resume it. With
``--expert-depth d`` the moments are measured under the ``d``-ply expert's
play (the exact rollout's expectimax, with the source's search coefs), the
right calibration for an expert-iteration run.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device
from ..algo import advantage as A
from ..algo import rollout as R
from ..ops import optimizer as opt
from . import checkpoint as CKPT
from .evaluate import load_model_checkpoint, load_search_coefs
from .loop import make_generator, train_state_leaves

# ``jax.random.key_data(jax.random.key(20260818))``: the JAX script's key.
WARMSTART_KEY = np.array([0, 20260818], np.uint32)
ROLLOUT_SEED = 123  # the JAX script's rollout key
ACTION, ENV = range(2)


def measure_moments(traj, weights: A.RewardWeights, gamma: float) -> tuple:
    """(mu, E[G^2], steps) of the returns-to-go of ``traj`` (an exact
    ``Trajectory``, or anything with its reward fields and ``valid``):
    ``step_rewards`` masked by ``valid``, ``returns_to_go``, then float64
    means over the valid steps."""
    r = A.step_rewards(traj.points, traj.mono_before, traj.mono_after,
                       traj.empt_before, traj.empt_after, weights, gamma)
    valid = torch.as_tensor(traj.valid)
    r = torch.where(valid, r, 0.0)
    G = A.returns_to_go(r, valid, gamma).cpu().numpy()
    m = valid.cpu().numpy().astype(np.float64)
    mu = float((G * m).sum() / m.sum())
    m2 = float((G * G * m).sum() / m.sum())
    return mu, m2, int(m.sum())


def rollout_for_moments(model, expert_depth: int = 0, coefs=None):
    """The rollout the moments are measured on: 128 sampled games to cap
    2,048, or under the ``expert_depth``-ply expert (``coefs``) 32 games at
    depth 2 or more and 128 at depth 1, to cap 2,560."""
    device = next(model.parameters()).device
    gens = dict(action_generator=make_generator(device, ROLLOUT_SEED, ACTION),
                env_generator=make_generator(device, ROLLOUT_SEED, ENV))
    if expert_depth:
        n_games = 32 if expert_depth >= 2 else 128
        return R.rollout(model, n_games, 2560, expert_depth=expert_depth,
                         expert_coefs=coefs, **gens)
    return R.rollout(model, 128, 2048, **gens)


def write_train_state(ckpt_dir, model, model_cfg, moments: tuple, train_step: int,
                      highest_score: int, best_manifest: dict, source: str) -> None:
    """``train_state`` in ``ckpt_dir``: ``model``'s parameters, a fresh
    optimizer state, the moments ``(mu, E[G^2])`` stored unbiased (the
    trainer divides them by 1 - rtg_beta^step, about 1 this far in), the
    key ``WARMSTART_KEY``, and the JAX script's manifest."""
    device = next(model.parameters()).device
    mu, m2 = (torch.tensor(v, dtype=torch.float64).to(device, torch.float32)
              for v in moments)
    leaves = train_state_leaves(model, opt.init(dict(model.named_parameters())),
                                A.RtgMoments(mu, m2, mu.clone()), WARMSTART_KEY)
    CKPT.save_checkpoint(ckpt_dir, "train_state", leaves=leaves, manifest=dict(
        train_step=train_step,
        highest_score=int(highest_score),
        best_eval_avg=float(best_manifest.get("eval_avg_score", 0.0)),
        emas=dict(avg_score=5000.0, pct_512=50.0, pct_1024=10.0, pct_2048=0.0,
                  explained_var=0.3),
        current_beta=0.02,
        config={}, model_config=model_cfg.to_dict(),
        warmstart=f"params from {source}/best_model "
                  f"(eval avg {best_manifest.get('eval_avg_score')}); "
                  "fresh optimizer; moments measured from a rollout"))


def warm_start(ckpt_dir="checkpoints_ht", train_step=4500, gamma=0.99, points_w=0.10,
               mono_w=1.0, src_dir=None, highest_score=0, expert_depth=0,
               device="cuda") -> tuple:
    """Write the warm-start ``train_state``; returns (mu, E[G^2], steps)."""
    source = src_dir or ckpt_dir
    model, model_cfg, _ = load_model_checkpoint(source, resolve_device(device))
    _, best_manifest = CKPT.load_checkpoint(source, "best_model")
    coefs = None
    if expert_depth:
        coefs = load_search_coefs(source)
        print(f"measuring moments under depth-{expert_depth} expert play ({coefs})")
    traj = rollout_for_moments(model, expert_depth, coefs)
    mu, m2, n = measure_moments(traj, A.RewardWeights(points=points_w,
                                                      monotonicity=mono_w), gamma)
    print(f"measured RTG moments: mu={mu:.3f} E[G^2]={m2:.3f} "
          f"(std={np.sqrt(m2 - mu * mu):.3f}) over {n} steps")
    write_train_state(ckpt_dir, model, model_cfg, (mu, m2), train_step, highest_score,
                      best_manifest, source)
    print(f"train_state written to {ckpt_dir} at step {train_step}")
    return mu, m2, n


def main(argv=None) -> tuple:
    ap = argparse.ArgumentParser(prog="python -m tpu2048_torch.train.warmstart",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt-dir", default="checkpoints_ht")
    ap.add_argument("--src-dir", default=None,
                    help="where to read best_model from (default: ckpt-dir)")
    ap.add_argument("--train-step", type=int, default=4500)
    ap.add_argument("--gamma", type=float, default=0.99)
    ap.add_argument("--points", type=float, default=0.10)
    ap.add_argument("--mono", type=float, default=1.0)
    ap.add_argument("--highest-score", type=int, default=0)
    ap.add_argument("--expert-depth", type=int, default=0,
                    help="Measure moments under expert (expectimax) play")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain merge)")
    a = ap.parse_args(argv)
    return warm_start(a.ckpt_dir, a.train_step, a.gamma, a.points, a.mono, a.src_dir,
                      a.highest_score, a.expert_depth, a.device)


if __name__ == "__main__":
    main()
