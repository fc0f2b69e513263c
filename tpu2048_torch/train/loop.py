"""The trainer (counterpart of ``tpu2048/train/loop.py``), for the MLP and
the URM: PPO, or expert iteration (``--expert-iter``), on one device or
data-parallel over several (``--mesh-data``).

One train step:

  1. the rollout: ``rollout_packed`` (``--packed``: every lane advances
     ``horizon`` steps, two merge launches a step, finished games reset in
     place, the best completed episode recorded on the device unless
     ``--no-packed-capture``) or the exact-episodes ``rollout`` (the
     default: ``--episodes`` games from fresh boards, each to its end or
     ``rollout_cap`` moves, one merge launch a step). Under
     ``--expert-iter`` the exact rollout also runs the expectimax teacher
     on every board of every trip: a frozen checkpoint (``--expert-src``)
     or the policy itself with coefs from the live moments;
  2. ``process``: returns-to-go and advantage, the augmentation plan, the
     PPO (or imitation, under ``--expert-iter``) minibatches with a
     Muon+AdamW step each, with the KL trust region against the run-start
     policy under ``--anchor-kl``, the batch statistics, stacked into one
     tensor that the host reads once.

plus the episode breakdown and last steps at print cadence and the viz JSON
(``--viz-dir``) at print cadence and on a new high, from the step's best
episode (exact mode) or the recorder's (packed mode); eval-in-train (sampled
games on a seeded spawn stream, ``best_model`` saved on a new best); full
train-state checkpoints with the lanes' state and the recorder's best
episode (``env_carry.npz``); adaptive entropy, EMAs and the metric log, as
the reference does them.

Randomness. JAX keys cannot be carried into ``torch.Generator``s, so the
port seeds its generators from the same uint32 data the JAX package stores:
``train_state.npz['key']`` (2,) and ``env_carry.npz['env_key_data']`` (2,).
Train step t's generators are seeded from ``np.random.SeedSequence((*key,
t, stream))`` for the streams ACTION, AUGMENT, PERMUTE, DROPOUT, EVAL and
EXACT_ENV (the exact rollout's fresh boards and spawns); the packed lanes'
spawns and resets from ``SeedSequence((*env_key_data, t))``. Both stay
constant through a run, so a run interrupted and resumed is bit-identical
on the CPU to one that was not, and a train state the JAX package wrote
resumes here. The streams themselves differ from the JAX package's.

Data parallelism (``--mesh-data D``; counterpart of
``tpu2048/parallel/train_step.py``). The step is
:func:`make_sharded_train_step`, given the rank's
:class:`~tpu2048_torch.parallel.mesh.DataGroup` (``None`` on one device,
where every collective is the identity). Its semantics are those of the JAX
package's ``shard_map`` step:

 * Each rank plays ``lanes / D`` (packed) or ``episodes / D`` (exact) games
   from its own streams, with no collective in the rollout.
 * The RTG batch moments are global, every minibatch's loss is normalised
   by the global sample count, and the gradients are summed over the ranks
   once per minibatch. Every rank runs the MAX over ranks of the minibatch
   counts; a rank whose shard is used up adds zero-weight batches.
 * Every logged statistic is global; exact mode's ``best_idx`` indexes the
   games of all ranks in rank order, and its ``steps_executed`` is the MAX
   over ranks. The parameters stay bit-identical on every rank.

Streams. The JAX package folds the device index into the step's key
(``fold_in(key, axis_index)``). Here rank r's generators take the words
above with r appended as one more word when r > 0. So rank 0's streams are
exactly the single-device trainer's, and D = 1 is that trainer bit for bit.

The packed lanes. Rank r's ``env_key`` row is ``SeedSequence((*key,
ENV_KEY, r))`` (rank 0: the single-device key); its lanes' spawns come from
that row and the step. A D-rank run saves the lanes in the JAX package's
mesh layout: ``boards``, ``ep_points`` and ``ep_moves`` of every rank in
rank order, and ``env_key_data`` of shape (D, 2), row r rank r's, under
``sharded_d = D``; a file of another ``sharded_d`` gives fresh boards.

The ranks are processes: ``parallel/train_step.py::launch`` starts them
(the CLI's ``--mesh-data``/``--num-processes``) and each runs :func:`train`
with its group.

At the end of a run, ``--export-demo`` writes the demo's assets to
``web/data`` (``train/export.py``) with the run's best episode. wandb is
not ported; ``--wandb`` raises ``NotImplementedError``
(:func:`check_ported`).
"""

from __future__ import annotations

import copy
import time
from dataclasses import asdict, dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..algo import advantage as A
from ..algo import augment as AUG
from ..algo import capture as CAPT
from ..algo import rollout as R
from ..algo import search
from ..algo import update as U
from ..env import engine, heuristics
from ..models import mlp, urm
from ..models.encoding import encode_boards
from ..ops import optimizer as opt
from ..ops import schedules
from ..parallel.mesh import DataGroup, all_extrema, all_sum
from ..utils import printing, viz_export
from ..utils import stats as S
from ..utils.logger import MetricLogger
from . import checkpoint as CKPT

DEFAULT_SCAN_CAP = 4096  # longest recorded reference game: 1249 moves


@dataclass
class TrainConfig:
    """The JAX package's ``TrainConfig`` (same fields and defaults), plus
    ``device``."""

    steps: int = 1000
    learning_rate: float = 0.001
    critic_lr: float = 0.001
    gamma: float = 0.99
    entropy_strength: float = 0.1
    critic_strength: float = 1.0
    num_episodes: int = 1
    batch_size: int = 1
    ppo_epochs: int = 1
    max_steps: Optional[int] = None
    hidden_size: int = 64
    num_layers: int = 2
    model_type: str = "mlp"
    num_heads: int = 4
    num_loops: int = 4
    num_truncated_loops: int = 1
    dropout: float = 0.1
    print_frequency: int = 10
    show_last_steps: int = 0
    points_weight: float = 0.0
    smoothness_weight: float = 0.0
    max_tile_weight: float = 0.0
    corner_weight: float = 0.0
    adjacency_weight: float = 0.0
    chain_weight: float = 0.0
    monotonicity_weight: float = 0.0
    emptiness_weight: float = 0.0
    topological_weight: float = 0.0
    win_bonus: float = 0.0
    warmup_steps: int = 200
    rtg_beta: float = 0.9
    viz_dir: Optional[str] = None
    log_dir: Optional[str] = None
    use_wandb: bool = False
    wandb_project: Optional[str] = "2048-rl"
    wandb_run_name: Optional[str] = None
    eval_freq: Optional[int] = None
    eval_games: int = 100
    decouple_critic: bool = False
    upsample_ratio: float = 0.0
    export_demo: bool = False
    checkpoint_dir: Optional[str] = "checkpoints"
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.01
    adaptive_beta: bool = False
    target_entropy: float = 0.7
    beta_min: float = 0.001
    beta_max: float = 1.0
    beta_lr: float = 0.01
    seed: int = 0
    resume: bool = False
    kl_diagnostic: bool = True
    scan_cap: int = DEFAULT_SCAN_CAP
    checkpoint_freq: Optional[int] = None
    mesh_data: int = 1
    eval_env_seed: int = 12345
    eval_fixed_stream: bool = False
    pipeline: bool = True
    expert_iter: bool = False
    expert_depth: int = 1
    expert_mix: float = 0.5
    expert_tau: float = 0.02
    expert_sharp: bool = True
    expert_src: Optional[str] = None
    anchor_kl: float = 0.0
    expert_bf16: bool = False
    packed: bool = False
    lanes: int = 0  # 0 -> num_episodes
    horizon: int = 512
    packed_capture: bool = True
    device: str = "cuda"

    @property
    def packed_lanes(self) -> int:
        return self.lanes or self.num_episodes

    @property
    def rollout_cap(self) -> int:
        return self.max_steps if self.max_steps else self.scan_cap

    @property
    def reward_weights(self) -> A.RewardWeights:
        return A.RewardWeights(
            points=self.points_weight, smoothness=self.smoothness_weight,
            max_tile=self.max_tile_weight, corner=self.corner_weight,
            adjacency=self.adjacency_weight, chain=self.chain_weight,
            monotonicity=self.monotonicity_weight,
            emptiness=self.emptiness_weight,
            topological=self.topological_weight, win_bonus=self.win_bonus)


def check_ported(cfg: TrainConfig) -> None:
    """Raise ``NotImplementedError`` for ``--wandb``, the one flag whose
    feature the port does not have; nothing is silently ignored. A
    configuration the reference refuses raises ``ValueError``."""
    if cfg.model_type.lower() not in ("mlp", "urm"):
        raise ValueError(f"Unknown model type: {cfg.model_type}. Use 'mlp' or 'urm'.")
    if cfg.packed and cfg.expert_iter:
        raise ValueError("--packed does not support --expert-iter (the expert "
                         "searcher needs exact-episode rollouts)")
    if cfg.use_wandb:
        raise NotImplementedError("--wandb: not ported (it needs the wandb package and "
                                  "the network; the JSONL metric log has the same metrics)")


# Streams of a train step's generators: SeedSequence((*key, step, stream)).
# A new stream takes the next number; none is renumbered.
ACTION, AUGMENT, PERMUTE, DROPOUT, EVAL, EXACT_ENV = range(6)
# Run-level streams: SeedSequence((*key, stream)).
INIT, ENV_KEY = range(2)


def seed_of(*words) -> int:
    """The first 64-bit word of ``np.random.SeedSequence(words)``."""
    return int(np.random.SeedSequence(tuple(int(w) for w in words))
               .generate_state(1, np.uint64)[0])


def make_generator(device, *words) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_of(*words))


def build_model(cfg: TrainConfig, generator: torch.Generator | None = None) -> tuple:
    """(model config, GameMLP or GameURM on the CPU with zeroed heads,
    routing labels)."""
    if cfg.model_type.lower() == "urm":
        mc = urm.URMConfig(hidden_dim=cfg.hidden_size, num_layers=cfg.num_layers,
                           num_heads=cfg.num_heads, dropout=cfg.dropout,
                           num_loops=cfg.num_loops,
                           num_truncated_loops=cfg.num_truncated_loops)
        model = urm.GameURM(mc, zero_heads=True, generator=generator)
        return mc, model, urm.param_labels(model)
    mc = mlp.MLPConfig(hidden_dim=cfg.hidden_size, num_layers=cfg.num_layers,
                       dropout=cfg.dropout, decouple_critic=cfg.decouple_critic)
    model = mlp.GameMLP(mc, zero_heads=True, generator=generator)
    return mc, model, mlp.param_labels(model)


def objective(cfg: TrainConfig) -> str:
    """The learner's loss (``update.LOSSES``) under ``cfg``."""
    if not cfg.expert_iter:
        return "ppo"
    return "imitation_sharp" if cfg.expert_sharp else "imitation"


def load_teacher(cfg: TrainConfig, device) -> tuple:
    """(the frozen teacher of ``--expert-src`` on ``device``, in eval mode
    without gradients, wrapped once in ``BF16Leaves`` under
    ``--expert-bf16``; its ``SearchCoefs``). An MLP or a URM checkpoint."""
    from .evaluate import load_model_checkpoint, load_search_coefs

    teacher, _, _ = load_model_checkpoint(cfg.expert_src, device)
    teacher.requires_grad_(False)
    if cfg.expert_bf16:
        teacher = search.BF16Leaves(teacher).eval()
    return teacher, load_search_coefs(cfg.expert_src)


def expert_args(cfg: TrainConfig, teacher, teacher_coefs, moments, rtg_step: int) -> dict:
    """``rollout``'s expert keyword arguments for 1-indexed train step
    ``rtg_step`` (none without ``--expert-iter``). Without a frozen
    ``teacher`` the policy teaches, with coefs from the step's moments (a
    fresh bf16 copy of it each step under ``--expert-bf16``)."""
    if not cfg.expert_iter:
        return {}
    coefs = teacher_coefs
    if teacher is None:
        coefs = search.coefs_from_moments(
            moments, rtg_step, cfg.points_weight, cfg.monotonicity_weight,
            cfg.emptiness_weight, cfg.gamma, cfg.rtg_beta)
    return dict(expert_depth=cfg.expert_depth, expert_coefs=coefs,
                expert_mix=cfg.expert_mix, expert_tau=cfg.expert_tau,
                expert_model=teacher, expert_bf16=cfg.expert_bf16)


_EXTRA_SCALARS = ("sched_mult", "batch_max_score", "batch_avg_score",
                  "pct_512", "pct_1024", "pct_2048", "best_idx", "env_steps")
SCALAR_KEYS = tuple(sorted(
    list(S.DSTAT_KEYS) + list(U.OptimizeStats._fields) + list(_EXTRA_SCALARS)))


def make_process_fn(cfg: TrainConfig, optimize_fn, group: DataGroup | None = None,
                    num_envs_local: int | None = None):
    """``process(opt_state, traj, moments, train_step, beta, *, generators=,
    aug_plan=None, perm_draws=None) -> (new_moments, outputs)``: advantage,
    augmentation plan, the learner's epochs and the statistics of one
    rollout, a PackedTrajectory when ``cfg.packed``, else a Trajectory of
    (rollout_cap, num_episodes) records. ``train_step`` is 1-indexed;
    ``outputs['scalars']`` stacks every scalar in ``SCALAR_KEYS`` order (one
    host transfer). ``generators`` maps AUGMENT/PERMUTE/DROPOUT to the
    step's generators; ``aug_plan`` and ``perm_draws`` replace their draws (a
    test replays the JAX package's).

    ``group``/``num_envs_local``: one rank's share of a data-parallel step
    (:func:`make_sharded_train_step`), its rollout of ``num_envs_local`` lanes or
    games; ``optimize_fn`` must be built with the same group. The moments
    and every statistic are then global; ``best_idx`` indexes the games of
    all ranks in rank order."""
    packed = cfg.packed
    T, N = (cfg.horizon, cfg.packed_lanes) if packed else (cfg.rollout_cap,
                                                           cfg.num_episodes)
    N = num_envs_local or N
    ranks = 1 if group is None else group.size
    num_slots = int(np.ceil(T * N * cfg.upsample_ratio)) if cfg.upsample_ratio > 0 else 0
    weights = cfg.reward_weights

    def process(opt_state, traj, moments, train_step: int, beta: float, *,
                generators: dict | None = None, aug_plan: AUG.AugPlan | None = None,
                perm_draws=None) -> tuple:
        generators = generators or {}
        device = traj.valid.device
        sched_mult = schedules.cosine_with_warmup(train_step - 1, cfg.warmup_steps,
                                                  cfg.steps)
        potentials = (traj.points, traj.mono_before, traj.mono_after, traj.empt_before,
                      traj.empt_after, traj.value_pred, traj.valid)
        if packed:
            adv = A.compute_packed(*potentials, traj.done_here, traj.boot_value, weights,
                                   cfg.gamma, moments, cfg.rtg_beta, train_step, group)
        else:
            adv = A.compute(*potentials, weights, cfg.gamma, moments, cfg.rtg_beta,
                            train_step, group)
        s_real = T * N
        flat_valid = traj.valid.reshape(s_real)

        def fb(x):
            return x.reshape((s_real,) + x.shape[2:])

        real = dict(board_before=fb(traj.board_before),
                    action=fb(traj.target_action).long(),
                    action_mask=fb(traj.action_mask),
                    advantage=fb(adv["advantage"]), G_norm=fb(adv["G_norm"]),
                    logprobs=fb(traj.logprobs), target_probs=fb(traj.target_probs))
        if num_slots > 0:
            if aug_plan is None:
                n_valid = flat_valid.sum()
                num_to_sample = torch.clamp(
                    (n_valid.to(torch.float32) * cfg.upsample_ratio).to(torch.int32),
                    max=num_slots)
                aug_plan = AUG.plan(generators.get(AUGMENT), num_slots,
                                    num_to_sample, flat_valid)
            dataset = U.Dataset(**real, valid=torch.cat([flat_valid, aug_plan.valid]),
                                aug_src=aug_plan.src, aug_tf=aug_plan.transform)
            aug_valid = aug_plan.valid
            aug_points = fb(traj.points)[aug_plan.src]
        else:
            dataset = U.Dataset(**real, valid=flat_valid)
            aug_valid = torch.zeros(1, dtype=torch.bool, device=device)
            aug_points = torch.zeros(1, dtype=torch.int32, device=device)

        ostats = optimize_fn(opt_state, dataset, beta, cfg.critic_strength, sched_mult,
                             perm_generator=generators.get(PERMUTE),
                             dropout_generator=generators.get(DROPOUT),
                             perm_draws=perm_draws)

        if packed:
            # Episode statistics over the chunk's completion records.
            flat_done = traj.done_here.reshape(-1)
            scalars = S.device_stats(traj, adv, aug_valid, aug_points,
                                     traj.ep_score.reshape(-1), flat_done,
                                     traj.ep_start.reshape(-1), group=group)
            tiles = traj.ep_tile
            n_done, score_sum, *counts, env_steps = all_sum(
                group, flat_done.to(torch.float32).sum(),
                traj.ep_score.to(torch.float32).sum(),
                *((tiles >= tile).sum() for tile in (512, 1024, 2048)), traj.valid.sum())
            n_ep = n_done.clamp(min=1.0)
            (max_score,), _ = all_extrema(group, (traj.ep_score.max(),))
            # A packed chunk has no per-lane best episode (it lives
            # mid-buffer): the recorder keeps it.
            best_idx = torch.zeros((), device=device)
        else:
            scalars = S.device_stats(traj, adv, aug_valid, aug_points, group=group)
            n_ep = torch.full((), float(N * ranks), device=device)
            tiles = engine.max_tile_value(traj.final_board.to(torch.int32))
            total_points = (traj.total_points if group is None
                            else group.gather(traj.total_points))
            points_sum, *counts, env_steps = all_sum(
                group, traj.total_points.sum(),
                *((tiles >= tile).sum() for tile in (512, 1024, 2048)),
                traj.num_moves.sum())
            score_sum = points_sum.to(torch.float32)
            max_score = total_points.max()
            best_idx = heuristics.first_max_index(total_points)
        scalars.update(ostats._asdict())
        pct_512, pct_1024, pct_2048 = (c / n_ep * 100.0 for c in counts)
        scalars.update(
            sched_mult=torch.full((), float(sched_mult), device=device),
            batch_max_score=max_score, batch_avg_score=score_sum / n_ep,
            pct_512=pct_512, pct_1024=pct_1024, pct_2048=pct_2048,
            best_idx=best_idx, env_steps=env_steps)
        stacked = torch.stack([scalars[k].to(torch.float32) for k in SCALAR_KEYS])
        return adv["new_moments"], dict(scalars=stacked, advantage=adv["advantage"])

    return process


def shard_sizes(cfg: TrainConfig, ranks: int) -> tuple:
    """(games or lanes a rank plays, its minibatch size); raises
    ``ValueError`` (the JAX package's message) unless both divide."""
    global_envs = cfg.packed_lanes if cfg.packed else cfg.num_episodes
    if global_envs % ranks or cfg.batch_size % ranks:
        raise ValueError(
            f"{'lanes' if cfg.packed else 'num_episodes'}={global_envs} and "
            f"batch_size={cfg.batch_size} must be divisible by data axis size {ranks}")
    return global_envs // ranks, cfg.batch_size // ranks


def rank_words(group: DataGroup | None) -> tuple:
    """The words a rank appends to the single-device seeds: none on rank 0."""
    return () if group is None or group.rank == 0 else (group.rank,)


def init_sharded_env_carry(group: DataGroup | None, key, num_lanes: int, device) -> R.EnvCarry:
    """This rank's ``num_lanes / D`` fresh lanes, spawned from its key
    (module docstring)."""
    local = num_lanes // (1 if group is None else group.size)
    env_key = np.random.SeedSequence(
        (*map(int, key), ENV_KEY, *rank_words(group))).generate_state(2, np.uint32)
    return R.init_env_carry(env_key, local, device, make_generator(device, *env_key))


class StepOut(NamedTuple):
    moments: object  # A.RtgMoments after the step
    outputs: dict  # scalars (SCALAR_KEYS order) and the rank's (T, N/D) advantage
    traj: object  # the rank's Trajectory or PackedTrajectory
    carry: object  # the rank's EnvCarry after the chunk (packed), else None
    recorder: object  # the updated recorder, when one was given
    rollout_s: float  # host seconds of the rollout


def make_sharded_train_step(group: DataGroup | None, cfg: TrainConfig, model, labels: dict,
                            opt_config, anchor: tuple | None = None,
                            teacher: tuple | None = None):
    """``step(opt_state, moments, key, train_step, beta, carry=None,
    recorder=None, *, rollout_draws=None, aug_plan=None, perm_draws=None)
    -> StepOut``: this rank's share of one train step (module docstring),
    training ``model`` (in place, as every rank does) and ``opt_state``;
    ``group`` None is the single-device step.

    ``cfg`` is the full TrainConfig: ``lanes``/``num_episodes`` and
    ``batch_size`` are global and must divide by the group's size.
    ``train_step`` is the 0-indexed step of the run (the stream word; the
    schedule and the moments take ``train_step + 1``), ``key`` the run's
    (2,) key. ``carry`` is the rank's EnvCarry in packed mode. ``anchor`` is
    ``(anchor_model, strength)``. ``teacher`` is ``(model, SearchCoefs)``
    of ``--expert-src``; without it the teacher is loaded here, once, so the
    frozen teacher is never replaced by the live one. ``rollout_draws``
    (the rollout's injected ``boards``/``actions``/``spawns``/``resets``),
    ``aug_plan`` and ``perm_draws`` replay another engine's draws."""
    local_envs, local_bs = shard_sizes(cfg, 1 if group is None else group.size)
    device = next(model.parameters()).device
    optimize_fn = U.make_optimize_fn(model, labels, opt_config, local_bs, cfg.ppo_epochs,
                                     kl_diagnostic=cfg.kl_diagnostic,
                                     objective=objective(cfg), anchor=anchor, group=group)
    process = make_process_fn(cfg, optimize_fn, group=group, num_envs_local=local_envs)
    if teacher is None and cfg.expert_iter and cfg.expert_src:
        teacher = load_teacher(cfg, device)
    e_model, e_coefs = teacher or (None, None)
    words = rank_words(group)

    def gen(key, train_step, stream):
        return make_generator(device, *key, train_step, stream, *words)

    def step(opt_state, moments, key, train_step: int, beta: float, carry=None,
             recorder=None, *, rollout_draws: dict | None = None, aug_plan=None,
             perm_draws=None) -> StepOut:
        t0 = time.perf_counter()
        draws = rollout_draws or {}
        if cfg.packed:
            out = R.rollout_packed(
                model, carry, cfg.horizon, action_generator=gen(key, train_step, ACTION),
                env_generator=make_generator(device, *carry.env_key, train_step),
                recorder=recorder, **draws)
            traj, carry = out[:2]
            recorder = out[2] if recorder is not None else None
        else:
            traj = R.rollout(
                model, local_envs, cfg.rollout_cap,
                action_generator=gen(key, train_step, ACTION),
                env_generator=gen(key, train_step, EXACT_ENV),
                **expert_args(cfg, e_model, e_coefs, moments, train_step + 1), **draws)
            if group is not None and group.size > 1:
                trips = group.max(torch.tensor(traj.steps_executed))
                traj = traj._replace(steps_executed=int(trips))
        t1 = time.perf_counter()
        gens = {s: gen(key, train_step, s) for s in (AUGMENT, PERMUTE, DROPOUT)}
        moments, outputs = process(opt_state, traj, moments, train_step + 1, beta,
                                   generators=gens, aug_plan=aug_plan, perm_draws=perm_draws)
        return StepOut(moments, outputs, traj, carry, recorder, t1 - t0)

    return step


_DELTA_OF = ("smoothness", "corner", "adjacency", "chain", "topological")
HEURISTIC_DELTAS = tuple(f"{k}_delta" for k in _DELTA_OF)


def _moved(boards: torch.Tensor, action: torch.Tensor) -> tuple:
    """(the boards after each move, before its spawn; the MoveSet)."""
    moves = engine.all_moves(boards)
    sel = action.long()[None, :, None, None].expand((1,) + boards.shape)
    return torch.gather(moves.boards, 0, sel)[0], moves


def make_episode_heuristics_fn():
    """``fn(board_before (T, 4, 4), action (T,)) -> dict`` of the five
    heuristic deltas (after the move, before its spawn, minus before; the
    topological score anchored at the before-board's corner) that the
    breakdown and the viz JSON read. One merge launch over the T boards."""

    def fn(board_before, action):
        b = board_before.to(torch.int32)
        anchor = heuristics.choose_anchor_corner(b)
        before = heuristics.full_suite(b, anchor)
        after = heuristics.full_suite(_moved(b, action)[0], anchor)
        return {f"{k}_delta": after[k] - before[k] for k in _DELTA_OF}

    return fn


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def _episode_moves(n, action, board_before, board_after, points, entropy, advantage,
                   max_created, mono_b, mono_a, empt_b, empt_a, heur) -> list:
    """The per-move dicts of an episode (the reference's EpisodeData)."""
    moves = []
    for t in range(n):
        m = {
            "selected_direction": int(action[t]),
            "state_before": board_before[t].tolist(),
            "result_state": board_after[t].tolist(),
            "points_earned": int(points[t]),
            "entropy": float(entropy[t]),
            "advantage": float(advantage[t]),
            "max_tile_created": int(max_created[t]),
            "monotonicity_before": float(mono_b[t]),
            "monotonicity_after": float(mono_a[t]),
            "emptiness_before": float(empt_b[t]),
            "emptiness_after": float(empt_a[t]),
        }
        if heur is not None:
            for k in HEURISTIC_DELTAS:
                m[k] = float(heur[k][t])
        moves.append(m)
    return moves


def fetch_episode(traj: R.Trajectory, advantage_tn, idx: int, heur_fn=None) -> dict:
    """Lane ``idx``'s episode of an exact-mode rollout as the host-side dict
    the printers and the viz exporter read."""
    n = int(traj.num_moves[idx])

    def lane(x):
        return _host(x[:n, idx])

    heur = None
    if heur_fn is not None:
        heur = {k: _host(v) for k, v in heur_fn(traj.board_before[:n, idx],
                                                traj.action[:n, idx]).items()}
    advantage = lane(advantage_tn) if advantage_tn is not None else np.zeros(n)
    moves = _episode_moves(
        n, lane(traj.action).astype(int), lane(traj.board_before).astype(int),
        lane(traj.board_after).astype(int), lane(traj.points).astype(int),
        lane(traj.entropy), advantage, lane(traj.max_created).astype(int),
        lane(traj.mono_before), lane(traj.mono_after), lane(traj.empt_before),
        lane(traj.empt_after), heur)
    return {
        "moves": moves,
        "total_points": int(traj.total_points[idx]),
        "total_steps": int(traj.total_steps[idx]),
        "final_state": _host(traj.final_board[idx]).astype(int).tolist(),
    }


def make_packed_mono_fn():
    """``fn(board_before (T, 4, 4), action (T,)) -> (mono_before, mono_after,
    empt_before, empt_after, max_created)`` of a recorded packed episode,
    which keeps only boards, actions, points and entropy: the two live
    potentials before the move and after it (before its spawn), and the
    move's largest created exponent. One merge launch over the T boards."""

    def fn(board_before, action):
        b = board_before.to(torch.int32)
        moved, moves = _moved(b, action)
        maxc = torch.gather(moves.max_created, 0, action.long()[None])[0]
        return (heuristics.monotonicity(b), heuristics.monotonicity(moved),
                heuristics.emptiness(b), heuristics.emptiness(moved), maxc)

    return fn


def fetch_packed_episode(rec: CAPT.EpisodeRecorder, heur_fn=None,
                         mono_fn=None) -> Optional[dict]:
    """The recorder's committed episode as the dict :func:`fetch_episode`
    gives, or None before an episode has completed. The reference's
    accounting: the advantage is 0.0 (the episode spans many chunks),
    ``total_steps`` is the true length - 1, the last move's after-potentials
    are zeroed only when the episode was not truncated, and
    ``truncated_at`` marks a truncated one."""
    n = int(rec.best_len)
    if n == 0:
        return None
    true_len = int(rec.best_true_len)
    before, action = rec.best_before[:n], rec.best_action[:n]
    zeros = np.zeros(n)
    mono_b = mono_a = empt_b = empt_a = maxc = zeros
    if mono_fn is not None:
        mono_b, mono_a, empt_b, empt_a, maxc = (_host(x) for x in mono_fn(before, action))
        if true_len == n:  # untruncated: the last move is terminal
            mono_a[-1] = 0
            empt_a[-1] = 0
    heur = None
    if heur_fn is not None:
        heur = {k: _host(v) for k, v in heur_fn(before, action).items()}
    board_after = _host(rec.best_after[:n]).astype(int)
    moves = _episode_moves(
        n, _host(action).astype(int), _host(before).astype(int), board_after,
        _host(rec.best_points[:n]).astype(int), _host(rec.best_entropy[:n]), zeros,
        maxc.astype(int), mono_b, mono_a, empt_b, empt_a, heur)
    ep = {
        "moves": moves,
        "total_points": int(rec.best_score),
        "total_steps": true_len - 1,
        "final_state": board_after[-1].tolist(),
    }
    if true_len > n:
        ep["truncated_at"] = n  # the recorder's cap; prefix and last move exact
    return ep


EVAL_KEYS = ("avg_score", "max_score", "median_score", "pct_1024", "pct_2048",
             "pct_512")


def make_eval_fn(cfg: TrainConfig):
    """``eval_fn(model, key, train_step, eval_idx) -> dict`` of EVAL_KEYS:
    ``eval_games`` sampled games played to the end (at most
    ``rollout_cap`` moves). The spawns come from a generator seeded by
    ``eval_env_seed`` and, unless ``eval_fixed_stream``, the eval round
    ``eval_idx``, so rounds see fresh but reproducible games; the actions
    from the step's EVAL generator."""
    games = cfg.eval_games

    def eval_fn(model, key, train_step: int, eval_idx: int) -> dict:
        device = next(model.parameters()).device
        env_words = ((cfg.eval_env_seed,) if cfg.eval_fixed_stream
                     else (cfg.eval_env_seed, eval_idx))
        env_gen = make_generator(device, *env_words)
        boards = engine.reset(games, device, generator=env_gen)
        res = R.play(model, boards, cfg.rollout_cap, env_gen, greedy=False,
                     action_generator=make_generator(device, *key, train_step, EVAL))
        scores = res.total_points.to(torch.float32)
        tiles = engine.max_tile_value(res.final_board)
        vals = dict(max_score=scores.max(), avg_score=scores.sum() / games,
                    median_score=torch.sort(scores).values[games // 2],
                    pct_512=(tiles >= 512).sum() / games * 100.0,
                    pct_1024=(tiles >= 1024).sum() / games * 100.0,
                    pct_2048=(tiles >= 2048).sum() / games * 100.0)
        got = torch.stack([vals[k].to(torch.float32) for k in EVAL_KEYS]).tolist()
        return dict(zip(EVAL_KEYS, got))

    return eval_fn


def _param_leaves(model, prefix="['params']") -> dict:
    return {prefix + CKPT.key_path(n): p.detach().cpu().numpy()
            for n, p in model.named_parameters()}


def train_state_leaves(model, opt_state, moments, key) -> dict:
    """The ``train_state.npz`` leaves under the JAX package's key paths."""
    leaves = _param_leaves(model)
    leaves.update(opt.state_to_arrays(opt_state, CKPT.key_path))
    for field in A.RtgMoments._fields:
        leaves[f"['moments'].{field}"] = getattr(moments, field).detach().cpu().numpy()
    leaves["['key']"] = np.asarray(key, np.uint32)
    return leaves


def load_train_state(ckpt_dir, model, device) -> tuple:
    """(opt_state, moments, key, manifest) from ``train_state.npz``, the
    parameters loaded into ``model``. The file must hold exactly the leaves
    this model's train state has; a missing or extra one raises."""
    arrays, manifest = CKPT.load_checkpoint(ckpt_dir, "train_state")
    names = [n for n, _ in model.named_parameters()]
    want = set(train_state_leaves(model, opt.init(dict(model.named_parameters())),
                                  A.RtgMoments.initial(), np.zeros(2, np.uint32)))
    missing, extra = sorted(want - set(arrays)), sorted(set(arrays) - want)
    if missing or extra:
        raise ValueError(f"train_state in {ckpt_dir} does not match the model: "
                         f"missing {missing[:5]}, unexpected {extra[:5]}")
    model.load_state_dict(CKPT.state_dict_from_arrays(arrays, names, ckpt_dir))
    opt_state = opt.state_from_arrays(arrays, names, CKPT.key_path, device)
    moments = A.RtgMoments(*(torch.as_tensor(arrays[f"['moments'].{f}"], dtype=torch.float32)
                             .to(device) for f in A.RtgMoments._fields))
    return opt_state, moments, np.asarray(arrays["['key']"], np.uint32), manifest


_CARRY_FIELDS = ("boards", "env_key_data", "ep_points", "ep_moves")
_BEST_DTYPES = dict(best_before=torch.int8, best_after=torch.int8,
                    best_action=torch.int8, best_points=torch.int32,
                    best_entropy=torch.float32, best_score=torch.int32,
                    best_len=torch.int32, best_true_len=torch.int32)


def save_env_carry(ckpt_dir, carry: R.EnvCarry, recorder: CAPT.EpisodeRecorder | None,
                   step: int, lanes: int, group: DataGroup | None = None) -> None:
    """The lanes' state as ``env_carry.npz``, beside ``train_state.npz``, so a
    resumed run goes on from the same boards, with the recorder's committed
    episode (its ``best_*`` fields; the lane buffers are not kept, and
    :func:`CAPT.mark_resumed` covers them on restore).

    Data-parallel ranks all call it with their ``group``: the lanes of every
    rank are gathered in rank order, the keys as a (D, 2) ``env_key_data``
    under ``sharded_d = D`` (the JAX package's mesh layout), and rank 0
    writes."""
    ranks = 1 if group is None else group.size
    env_key = np.asarray(carry.env_key, np.uint32)
    boards, ep_points, ep_moves = carry.boards, carry.ep_points, carry.ep_moves
    if ranks > 1:
        boards, ep_points, ep_moves = (group.gather(x) for x in (boards, ep_points, ep_moves))
        keys = group.gather(torch.as_tensor(env_key.astype(np.int64))[None])
        env_key = keys.cpu().numpy().astype(np.uint32)
        if group.rank != 0:
            return
    leaves = {"['boards']": _host(boards), "['env_key_data']": env_key,
              "['ep_points']": _host(ep_points), "['ep_moves']": _host(ep_moves)}
    if recorder is not None:
        leaves.update({f"['{k}']": _host(getattr(recorder, k)) for k in CAPT.BEST_FIELDS})
    CKPT.save_checkpoint(ckpt_dir, "env_carry", leaves=leaves,
                         manifest=dict(train_step=step, lanes=lanes, sharded_d=ranks,
                                       has_recorder=recorder is not None))


def load_env_carry(ckpt_dir, lanes: int, cap: int, device, logger,
                   group: DataGroup | None = None) -> tuple:
    """(EnvCarry, the recorder's ``best_*`` fields or None) saved by
    :func:`save_env_carry` or by the JAX package; (None, None) when there is
    none or it does not fit (another lane count or mesh layout,
    unreadable), and the caller then keeps its fresh boards. The best
    episode is restored when the file has one of ``cap`` moves. A rank of a
    ``group`` of D reads a file of ``sharded_d = D``, taking its slice of
    the lanes and its row of the keys."""
    if not CKPT.checkpoint_exists(ckpt_dir, "env_carry"):
        return None, None
    try:
        arrays, manifest = CKPT.load_checkpoint(ckpt_dir, "env_carry")
        fields = {f: arrays[f"['{f}']"] for f in _CARRY_FIELDS}
    except (CKPT.CheckpointCorruptError, KeyError, ValueError) as e:
        logger.print(f"env_carry checkpoint unreadable ({e}); starting from fresh boards")
        return None, None
    if manifest.get("lanes") != lanes:
        logger.print(f"env_carry checkpoint is for {manifest.get('lanes')} lanes, "
                     f"run uses {lanes}: starting from fresh boards")
        return None, None
    ranks = 1 if group is None else group.size
    if manifest.get("sharded_d", 1) != ranks:
        logger.print("env_carry checkpoint mesh layout changed "
                     f"({manifest.get('sharded_d', 1)} -> {ranks}): starting from fresh boards")
        return None, None
    env_key = np.asarray(fields["env_key_data"], np.uint32)
    if ranks > 1:
        local = lanes // ranks
        part = slice(group.rank * local, (group.rank + 1) * local)
        fields = {k: v[part] for k, v in fields.items() if k != "env_key_data"}
        env_key = env_key[group.rank]

    def put(x, dtype=torch.int32):
        return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dtype)

    carry = R.EnvCarry(put(fields["boards"]), env_key, put(fields["ep_points"]),
                       put(fields["ep_moves"]))
    best = None
    if (manifest.get("has_recorder") and "['best_action']" in arrays
            and arrays["['best_action']"].shape[0] == cap):
        best = {k: put(arrays[f"['{k}']"], dtype) for k, dtype in _BEST_DTYPES.items()}
    return carry, best


class QuietLogger:
    """The logger of a rank other than 0: it prints and logs nothing."""

    def log(self, *args, **kwargs) -> None:
        pass

    def print(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass


def train(cfg: TrainConfig, on_step: Callable[[dict], None] | None = None, *,
          group: DataGroup | None = None) -> dict:
    """Run the trainer; returns a summary dict.

    ``on_step``, when given, is called after every train step with a dict:
    ``step`` (0-indexed), ``model``, ``opt_state``, ``moments``, ``traj``,
    ``carry_in`` (the packed lanes' state before the step, else None),
    ``recorder`` (the packed recorder after the step, else None; its lane
    buffers are written in place by the next step), ``scalars`` (by
    SCALAR_KEYS), ``rollout_s`` (host seconds to run the rollout),
    ``learner_s`` (host seconds from there to the scalars on the host). The
    run's own work does not depend on it.

    Data parallelism (module docstring): each rank runs this with its
    ``group`` on the group's device; without one, ``cfg.mesh_data`` must be
    1 (``parallel/train_step.py::launch`` starts the ranks). Only rank 0
    logs, prints, and writes
    checkpoints and viz; every rank runs the same steps and evals on the
    global statistics, so they stay in lockstep. The packed recorder is off
    (as in the JAX package's mesh). A run of one process saves and restores
    the lanes of every rank and fetches an exact-mode best episode from the
    rank that played it; a run over several processes does neither (fresh
    boards on resume, no episode)."""
    check_ported(cfg)
    if group is None and cfg.mesh_data > 1:
        raise ValueError(f"--mesh-data {cfg.mesh_data} runs one train per rank, each with "
                         "its group: start them with parallel.train_step.launch")
    ranks = 1 if group is None else group.size
    rank0 = group is None or group.rank == 0
    multihost = group is not None and group.num_processes > 1
    device = resolve_device(cfg.device) if group is None else group.device
    logger = (MetricLogger(cfg.log_dir, experiment_name=f"train_{cfg.model_type}") if rank0
              else QuietLogger())
    logger.print(f"Using devices: [{device}]" if ranks == 1 else
                 f"Data-parallel ranks: {ranks} ({group.backend}, {group.num_processes} "
                 f"process(es)); rank 0 on [{device}]")

    key = np.array([cfg.seed >> 32, cfg.seed & 0xFFFFFFFF], np.uint32)
    model_cfg, model, labels = build_model(cfg, make_generator("cpu", *key, INIT))
    model.to(device).eval()
    params = dict(model.named_parameters())
    opt_cfg = opt.OptimizerConfig(learning_rate=cfg.learning_rate, critic_lr=cfg.critic_lr,
                                  beta1=cfg.beta1, beta2=cfg.beta2,
                                  weight_decay=cfg.weight_decay)
    opt_state = opt.init(params)
    moments = A.RtgMoments.initial(device)

    start_step, highest_score, best_eval_avg = 0, 0, 0.0
    ema_decay = 0.001
    emas = dict(avg_score=0.0, pct_512=0.0, pct_1024=0.0, pct_2048=0.0,
                explained_var=0.0)
    current_beta = cfg.entropy_strength
    best_game_episode = None
    if cfg.resume and cfg.checkpoint_dir and CKPT.checkpoint_exists(
            cfg.checkpoint_dir, "train_state"):
        opt_state, moments, key, manifest = load_train_state(cfg.checkpoint_dir, model, device)
        start_step = int(manifest["train_step"]) + 1
        highest_score = manifest.get("highest_score", 0)
        best_eval_avg = manifest.get("best_eval_avg", 0.0)
        emas.update(manifest.get("emas", {}))
        current_beta = manifest.get("current_beta", current_beta)
        logger.print(f"Resumed from step {start_step}")

    lanes = cfg.packed_lanes
    env_carry = recorder = None
    capture_on = cfg.packed and cfg.packed_capture and ranks == 1
    if cfg.packed:
        logger.print(f"Packed rollout: {lanes} auto-reset lanes x {cfg.horizon} "
                     f"steps/train-step ({lanes * cfg.horizon} env steps/step, "
                     "100% lane occupancy)")
        env_carry = init_sharded_env_carry(group, key, lanes, device)
        if capture_on:
            recorder = CAPT.init_recorder(lanes, cfg.scan_cap, device)
        if cfg.resume and cfg.checkpoint_dir and not multihost:
            restored, best = load_env_carry(cfg.checkpoint_dir, lanes, cfg.scan_cap,
                                            device, logger, group)
            if restored is not None:
                env_carry = restored
                logger.print("Resumed packed env carry (lanes continue on-policy)")
                if capture_on:
                    recorder = CAPT.mark_resumed(recorder, restored.ep_moves)
            if best is not None and capture_on:
                recorder = recorder._replace(**best)

    # The KL trust region's anchor: the policy as the run starts (after a
    # resume), frozen.
    anchor = None
    if cfg.anchor_kl > 0.0:
        anchor = (copy.deepcopy(model).eval().requires_grad_(False), cfg.anchor_kl)
        logger.print(f"Anchor KL trust region: strength {cfg.anchor_kl} "
                     "vs the run-start policy")
    teacher = None
    if cfg.expert_iter and cfg.expert_src:
        teacher = load_teacher(cfg, device)
        logger.print(f"Expert iteration: FROZEN depth-{cfg.expert_depth} expectimax "
                     f"teacher from {cfg.expert_src} (sigma={teacher[1].sigma:.1f}, "
                     f"mu={teacher[1].mu:.1f})")
    elif cfg.expert_iter:
        logger.print(f"Expert iteration: depth-{cfg.expert_depth} expectimax rollout, "
                     "imitation + value objective")

    step_fn = make_sharded_train_step(group, cfg, model, labels, opt_cfg, anchor=anchor,
                                      teacher=teacher)
    eval_fn = make_eval_fn(cfg) if cfg.eval_freq else None
    heur_fn = make_episode_heuristics_fn()
    mono_fn = make_packed_mono_fn() if capture_on else None
    local_games = cfg.num_episodes // ranks

    # Sanity forward on a fresh board (the reference prints it).
    with torch.no_grad():
        test_board = engine.reset(1, device, generator=make_generator(device, 99))
        tl, tv = model(encode_boards(test_board))
    logger.print(f"Initial action logits: {tl.cpu().numpy()}")
    logger.print(f"Initial value logit: {tv.cpu().numpy()}")

    def save_train_state(step: int) -> None:
        if not cfg.checkpoint_dir:
            return
        if rank0:
            CKPT.save_checkpoint(
                cfg.checkpoint_dir, "train_state",
                leaves=train_state_leaves(model, opt_state, moments, key),
                manifest=dict(train_step=step, highest_score=int(highest_score),
                              best_eval_avg=float(best_eval_avg), emas=emas,
                              current_beta=float(current_beta), config=asdict(cfg),
                              model_config=model_cfg.to_dict()))
        if cfg.packed and not multihost:
            save_env_carry(cfg.checkpoint_dir, env_carry, recorder, step, lanes, group)

    t_start = time.time()
    env_steps_total = 0
    for train_step in range(start_step, cfg.steps):
        t0 = time.perf_counter()
        env_carry_in = env_carry
        res = step_fn(opt_state, moments, key, train_step, current_beta, env_carry, recorder)
        traj, env_carry, recorder, moments, out = (res.traj, res.carry, res.recorder,
                                                   res.moments, res.outputs)
        t1 = t0 + res.rollout_s
        # The one transfer of the step's scalars to the host.
        sc = dict(zip(SCALAR_KEYS, out["scalars"].cpu().tolist()))
        t2 = time.perf_counter()

        if cfg.adaptive_beta:
            entropy_error = cfg.target_entropy - sc["entropy"]
            current_beta = float(np.clip(current_beta * (1.0 + cfg.beta_lr * entropy_error),
                                         cfg.beta_min, cfg.beta_max))
        new_high = int(sc["batch_max_score"]) > highest_score
        highest_score = max(int(sc["batch_max_score"]), highest_score)
        env_steps_total += int(sc["env_steps"])
        p512, p1024, p2048 = sc["pct_512"], sc["pct_1024"], sc["pct_2048"]
        for k, v in (("avg_score", sc["batch_avg_score"]), ("pct_512", p512),
                     ("pct_1024", p1024), ("pct_2048", p2048),
                     ("explained_var", sc["explained_var"])):
            emas[k] = (1 - ema_decay) * emas[k] + ema_decay * v
        metrics = S.assemble_metrics(
            sc, sc, highest_score=highest_score, ema_avg_score=emas["avg_score"],
            ema_pct_512=emas["pct_512"], ema_pct_1024=emas["pct_1024"],
            ema_pct_2048=emas["pct_2048"], batch_pct_512=p512,
            batch_pct_1024=p1024, batch_pct_2048=p2048,
            ema_explained_var=emas["explained_var"], current_beta=current_beta,
            lr=cfg.learning_rate * sc["sched_mult"])
        should_print = train_step % cfg.print_frequency == 0
        logger.log(metrics, step=train_step, verbose=should_print)

        # The best episode: the step's best game (exact mode; fetched from
        # the rank that played it) or the recorder's committed episode
        # (packed mode with capture). Every rank takes the same branches.
        fetchable = (not cfg.packed or capture_on) and not multihost
        if cfg.packed:
            def fetch(heur=None):
                return fetch_packed_episode(recorder, heur_fn=heur, mono_fn=mono_fn)
        else:
            def fetch(heur=None):
                owner, idx = divmod(int(sc["best_idx"]), local_games)
                mine = group is None or group.rank == owner
                ep = fetch_episode(traj, out["advantage"], idx, heur_fn=heur) if mine else None
                return ep if group is None else group.broadcast_object(ep, owner)
        if new_high and fetchable:
            best_game_episode = fetch() or best_game_episode
        if (should_print or (new_high and cfg.viz_dir)) and fetchable:
            episode = fetch(heur_fn)
            if episode is not None and should_print:
                printing.print_episode_breakdown(logger, episode, cfg.reward_weights,
                                                 cfg.gamma)
                if cfg.show_last_steps > 0:
                    printing.print_last_steps(logger, episode, cfg.show_last_steps)
                printing.print_final_state(logger, episode)
            if episode is not None and cfg.viz_dir and rank0:
                viz_export.export_episode_visualization(
                    cfg.viz_dir, train_step, episode, cfg.reward_weights, cfg.gamma)

        if eval_fn and train_step > 0 and train_step % cfg.eval_freq == 0:
            logger.print(f"[Step {train_step}] Evaluating model on {cfg.eval_games} games")
            em = eval_fn(model, key, train_step, train_step // cfg.eval_freq)
            logger.log({f"eval/{k}": em[k] for k in (
                "max_score", "avg_score", "median_score", "pct_512", "pct_1024",
                "pct_2048")}, step=train_step)
            logger.print(f"Eval Results - Max: {em['max_score']:.0f}, Avg: "
                         f"{em['avg_score']:.1f}, Median: {em['median_score']:.0f}")
            logger.print(f"Tiles Reached - 512: {em['pct_512']:.1f}%, 1024: "
                         f"{em['pct_1024']:.1f}%, 2048: {em['pct_2048']:.1f}%")
            if em["avg_score"] > best_eval_avg and cfg.checkpoint_dir:
                best_eval_avg = em["avg_score"]
                if rank0:
                    CKPT.save_checkpoint(
                        cfg.checkpoint_dir, "best_model", leaves=_param_leaves(model),
                        manifest=dict(config=model_cfg.to_dict(),
                                      model_type=cfg.model_type,
                                      eval_avg_score=best_eval_avg, train_step=train_step))
                logger.print(f"New best model saved (avg score: {best_eval_avg:.1f}) "
                             f"to {cfg.checkpoint_dir}/best_model.npz")

        if cfg.checkpoint_freq and train_step > 0 and train_step % cfg.checkpoint_freq == 0:
            save_train_state(train_step)
        if on_step is not None:
            on_step(dict(step=train_step, model=model, opt_state=opt_state,
                         moments=moments, traj=traj, carry_in=env_carry_in,
                         recorder=recorder, scalars=sc, rollout_s=t1 - t0,
                         learner_s=t2 - t1))

    elapsed = time.time() - t_start
    steps_run = cfg.steps - start_step
    if steps_run > 0:
        logger.print(f"\nTrained {steps_run} steps, {env_steps_total} env steps in "
                     f"{elapsed:.1f}s ({env_steps_total / max(elapsed, 1e-9):.0f} "
                     "env steps/s)")
        # Only when steps ran: a resume that starts past cfg.steps must not
        # overwrite the further-along checkpoint with step cfg.steps - 1 (the
        # step drives the moments' bias correction).
        save_train_state(cfg.steps - 1)

    if cfg.export_demo and rank0:
        from .evaluate import load_search_coefs
        from .export import export_demo_assets

        logger.print("\nExporting demo assets to web/data/ ...")
        export_demo_assets(model, model_cfg, cfg.model_type, best_game_episode,
                           "web/data", search_coefs=load_search_coefs(cfg.checkpoint_dir))
    logger.close()
    return dict(model=model, moments=moments, highest_score=highest_score,
                best_game_episode=best_game_episode, recorder=recorder, emas=emas,
                env_steps_total=env_steps_total, elapsed=elapsed,
                best_eval_avg=best_eval_avg, current_beta=current_beta)
