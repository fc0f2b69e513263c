"""The packed PPO trainer for the MLP (counterpart of the single-device packed
path of ``tpu2048/train/loop.py``).

One train step:

  1. ``rollout_packed``: every lane advances ``horizon`` steps (two merge
     launches a step), finished games reset in place;
  2. ``process``: returns-to-go and advantage, the augmentation plan, the
     PPO minibatches with a Muon+AdamW step each, the batch statistics,
     stacked into one tensor that the host reads once.

plus eval-in-train (sampled games on a seeded spawn stream, ``best_model``
saved on a new best), full train-state checkpoints with the lanes' state
(``env_carry.npz``), adaptive entropy, EMAs and the metric log, as the
reference does them.

Randomness. JAX keys cannot be carried into ``torch.Generator``s, so the
port seeds its generators from the same uint32 data the JAX package stores:
``train_state.npz['key']`` (2,) and ``env_carry.npz['env_key_data']`` (2,).
Train step t's action, augmentation, permutation, dropout and eval
generators are seeded from ``np.random.SeedSequence((*key, t, stream))``,
the lanes' spawns and resets from ``SeedSequence((*env_key_data, t))``. Both
stay constant through a run, so a run interrupted and resumed is
bit-identical on the CPU to one that was not, and a train state the JAX
package wrote resumes here. The streams themselves differ from the JAX
package's.

Only the packed MLP trainer is ported; a configuration that needs anything
else raises ``NotImplementedError`` (:func:`check_ported`).
"""

from __future__ import annotations

import time
from dataclasses import asdict, dataclass
from typing import Callable, Optional

import numpy as np
import torch

from .. import resolve_device
from ..algo import advantage as A
from ..algo import augment as AUG
from ..algo import rollout as R
from ..algo import update as U
from ..env import engine
from ..models.encoding import encode_boards
from ..models.mlp import GameMLP, MLPConfig, param_labels
from ..ops import optimizer as opt
from ..ops import schedules
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
    """Raise ``NotImplementedError`` naming every flag of ``cfg`` whose
    feature the port does not have yet; nothing is silently ignored."""
    if cfg.model_type.lower() not in ("mlp", "urm"):
        raise ValueError(f"Unknown model type: {cfg.model_type}. Use 'mlp' or 'urm'.")
    unported = [flag for flag, on in (
        ("-t/--model-type urm", cfg.model_type.lower() == "urm"),
        ("a run without --packed (the exact-episodes trainer)", not cfg.packed),
        ("--expert-iter", cfg.expert_iter),
        ("--anchor-kl > 0", cfg.anchor_kl > 0),
        ("--mesh-data > 1", cfg.mesh_data > 1),
        ("--viz-dir", cfg.viz_dir is not None),
        ("--export-demo", cfg.export_demo),
        ("--wandb", cfg.use_wandb),
        ("--show-last-steps > 0", cfg.show_last_steps > 0),
        ("packed capture (on by default; pass --no-packed-capture)",
         cfg.packed and cfg.packed_capture),
    ) if on]
    if unported:
        raise NotImplementedError(
            "; ".join(unported) + ": not yet ported (ROADMAP.md)")


# Streams of a train step's generators: SeedSequence((*key, step, stream)).
ACTION, AUGMENT, PERMUTE, DROPOUT, EVAL = range(5)
# Run-level streams: SeedSequence((*key, stream)).
INIT, ENV_KEY = range(2)


def seed_of(*words) -> int:
    """The first 64-bit word of ``np.random.SeedSequence(words)``."""
    return int(np.random.SeedSequence(tuple(int(w) for w in words))
               .generate_state(1, np.uint64)[0])


def make_generator(device, *words) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_of(*words))


def build_model(cfg: TrainConfig, generator: torch.Generator | None = None) -> tuple:
    """(model config, GameMLP on the CPU with zeroed heads, routing labels)."""
    mc = MLPConfig(hidden_dim=cfg.hidden_size, num_layers=cfg.num_layers,
                   dropout=cfg.dropout, decouple_critic=cfg.decouple_critic)
    model = GameMLP(mc, zero_heads=True, generator=generator)
    return mc, model, param_labels(model)


_EXTRA_SCALARS = ("sched_mult", "batch_max_score", "batch_avg_score",
                  "pct_512", "pct_1024", "pct_2048", "best_idx", "env_steps")
SCALAR_KEYS = tuple(sorted(
    list(S.DSTAT_KEYS) + list(U.OptimizeStats._fields) + list(_EXTRA_SCALARS)))


def make_process_fn(cfg: TrainConfig, optimize_fn):
    """``process(opt_state, traj, moments, train_step, beta, *, generators=,
    aug_plan=None, perm_draws=None) -> (new_moments, outputs)``: advantage,
    augmentation plan, the learner's epochs and the statistics of one packed
    chunk. ``train_step`` is 1-indexed; ``outputs['scalars']`` stacks every
    scalar in ``SCALAR_KEYS`` order (one host transfer). ``generators``
    maps AUGMENT/PERMUTE/DROPOUT to the step's generators; ``aug_plan`` and
    ``perm_draws`` replace their draws (a test replays the JAX package's)."""
    T, N = cfg.horizon, cfg.packed_lanes
    num_slots = int(np.ceil(T * N * cfg.upsample_ratio)) if cfg.upsample_ratio > 0 else 0
    weights = cfg.reward_weights

    def process(opt_state, traj: R.PackedTrajectory, moments, train_step: int,
                beta: float, *, generators: dict | None = None,
                aug_plan: AUG.AugPlan | None = None, perm_draws=None) -> tuple:
        generators = generators or {}
        device = traj.valid.device
        sched_mult = schedules.cosine_with_warmup(train_step - 1, cfg.warmup_steps,
                                                  cfg.steps)
        adv = A.compute_packed(
            traj.points, traj.mono_before, traj.mono_after, traj.empt_before,
            traj.empt_after, traj.value_pred, traj.valid, traj.done_here,
            traj.boot_value, weights, cfg.gamma, moments, cfg.rtg_beta, train_step)
        s_real = T * N
        flat_valid = traj.valid.reshape(s_real)

        def fb(x):
            return x.reshape((s_real,) + x.shape[2:])

        real = dict(board_before=fb(traj.board_before),
                    action=fb(traj.target_action).long(),
                    action_mask=fb(traj.action_mask),
                    advantage=fb(adv["advantage"]), G_norm=fb(adv["G_norm"]),
                    logprobs=fb(traj.logprobs))
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

        flat_done = traj.done_here.reshape(-1)
        scalars = S.device_stats(traj, adv, aug_valid, aug_points,
                                 traj.ep_score.reshape(-1), flat_done,
                                 traj.ep_start.reshape(-1))
        scalars.update(ostats._asdict())
        n_done = flat_done.to(torch.float32).sum().clamp(min=1.0)

        def pct(tile):
            return (traj.ep_tile >= tile).sum() / n_done * 100.0

        scalars.update(
            sched_mult=torch.full((), float(sched_mult), device=device),
            batch_max_score=traj.ep_score.max(),
            batch_avg_score=traj.ep_score.to(torch.float32).sum() / n_done,
            pct_512=pct(512), pct_1024=pct(1024), pct_2048=pct(2048),
            # A packed chunk has no per-lane best episode (it lives mid-buffer).
            best_idx=torch.zeros((), device=device),
            env_steps=traj.valid.sum())
        stacked = torch.stack([scalars[k].to(torch.float32) for k in SCALAR_KEYS])
        return adv["new_moments"], dict(scalars=stacked, advantage=adv["advantage"])

    return process


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


def save_env_carry(ckpt_dir, carry: R.EnvCarry, step: int, lanes: int) -> None:
    """The lanes' state as ``env_carry.npz``, beside ``train_state.npz``, so a
    resumed run goes on from the same boards. The port has no best-episode
    recorder, so no recorder fields are written (``has_recorder: false``)."""
    leaves = {"['boards']": carry.boards.cpu().numpy(),
              "['env_key_data']": np.asarray(carry.env_key, np.uint32),
              "['ep_points']": carry.ep_points.cpu().numpy(),
              "['ep_moves']": carry.ep_moves.cpu().numpy()}
    CKPT.save_checkpoint(ckpt_dir, "env_carry", leaves=leaves,
                         manifest=dict(train_step=step, lanes=lanes, sharded_d=1,
                                       has_recorder=False))


def load_env_carry(ckpt_dir, lanes: int, device, logger) -> Optional[R.EnvCarry]:
    """The lanes' state saved by :func:`save_env_carry` (or by the JAX
    package, whose recorder fields are ignored), or None when there is none
    or it does not fit (another lane count or mesh layout, unreadable); the
    caller then keeps its fresh boards."""
    if not CKPT.checkpoint_exists(ckpt_dir, "env_carry"):
        return None
    try:
        arrays, manifest = CKPT.load_checkpoint(ckpt_dir, "env_carry")
        fields = {f: arrays[f"['{f}']"] for f in _CARRY_FIELDS}
    except (CKPT.CheckpointCorruptError, KeyError, ValueError) as e:
        logger.print(f"env_carry checkpoint unreadable ({e}); starting from fresh boards")
        return None
    if manifest.get("lanes") != lanes:
        logger.print(f"env_carry checkpoint is for {manifest.get('lanes')} lanes, "
                     f"run uses {lanes}: starting from fresh boards")
        return None
    if manifest.get("sharded_d", 1) != 1:
        logger.print("env_carry checkpoint mesh layout changed "
                     f"({manifest.get('sharded_d')} -> 1): starting from fresh boards")
        return None

    def put(x):
        return torch.as_tensor(np.asarray(x, np.int32)).to(device)

    return R.EnvCarry(put(fields["boards"]), np.asarray(fields["env_key_data"], np.uint32),
                      put(fields["ep_points"]), put(fields["ep_moves"]))


def train(cfg: TrainConfig, on_step: Callable[[dict], None] | None = None) -> dict:
    """Run the packed trainer; returns a summary dict.

    ``on_step``, when given, is called after every train step with a dict:
    ``step`` (0-indexed), ``model``, ``opt_state``, ``moments``, ``traj``,
    ``scalars`` (by SCALAR_KEYS), ``rollout_s`` (host seconds to run the
    rollout), ``learner_s`` (host seconds from there to the scalars on the
    host). The run's own work does not depend on it."""
    check_ported(cfg)
    device = resolve_device(cfg.device)
    logger = MetricLogger(cfg.log_dir, experiment_name=f"train_{cfg.model_type}")
    logger.print(f"Using devices: [{device}]")

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
    logger.print(f"Packed rollout: {lanes} auto-reset lanes x {cfg.horizon} "
                 f"steps/train-step ({lanes * cfg.horizon} env steps/step, "
                 "100% lane occupancy)")
    env_key = np.random.SeedSequence((*map(int, key), ENV_KEY)).generate_state(2, np.uint32)
    env_carry = R.init_env_carry(env_key, lanes, device, make_generator(device, *env_key))
    if cfg.resume and cfg.checkpoint_dir:
        restored = load_env_carry(cfg.checkpoint_dir, lanes, device, logger)
        if restored is not None:
            env_carry = restored
            logger.print("Resumed packed env carry (lanes continue on-policy)")

    optimize_fn = U.make_optimize_fn(model, labels, opt_cfg, cfg.batch_size,
                                     cfg.ppo_epochs, kl_diagnostic=cfg.kl_diagnostic)
    process_fn = make_process_fn(cfg, optimize_fn)
    eval_fn = make_eval_fn(cfg) if cfg.eval_freq else None

    # Sanity forward on a fresh board (the reference prints it).
    with torch.no_grad():
        test_board = engine.reset(1, device, generator=make_generator(device, 99))
        tl, tv = model(encode_boards(test_board))
    logger.print(f"Initial action logits: {tl.cpu().numpy()}")
    logger.print(f"Initial value logit: {tv.cpu().numpy()}")

    def save_train_state(step: int) -> None:
        if not cfg.checkpoint_dir:
            return
        CKPT.save_checkpoint(
            cfg.checkpoint_dir, "train_state",
            leaves=train_state_leaves(model, opt_state, moments, key),
            manifest=dict(train_step=step, highest_score=int(highest_score),
                          best_eval_avg=float(best_eval_avg), emas=emas,
                          current_beta=float(current_beta), config=asdict(cfg),
                          model_config=model_cfg.to_dict()))
        save_env_carry(cfg.checkpoint_dir, env_carry, step, lanes)

    t_start = time.time()
    env_steps_total = 0
    for train_step in range(start_step, cfg.steps):
        t0 = time.perf_counter()
        env_carry_in = env_carry
        traj, env_carry = R.rollout_packed(
            model, env_carry_in, cfg.horizon,
            action_generator=make_generator(device, *key, train_step, ACTION),
            env_generator=make_generator(device, *env_carry_in.env_key, train_step))
        t1 = time.perf_counter()
        gens = {s: make_generator(device, *key, train_step, s)
                for s in (AUGMENT, PERMUTE, DROPOUT)}
        moments, out = process_fn(opt_state, traj, moments, train_step + 1,
                                  current_beta, generators=gens)
        # The one transfer of the step's scalars to the host.
        sc = dict(zip(SCALAR_KEYS, out["scalars"].cpu().tolist()))
        t2 = time.perf_counter()

        if cfg.adaptive_beta:
            entropy_error = cfg.target_entropy - sc["entropy"]
            current_beta = float(np.clip(current_beta * (1.0 + cfg.beta_lr * entropy_error),
                                         cfg.beta_min, cfg.beta_max))
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
        logger.log(metrics, step=train_step,
                   verbose=train_step % cfg.print_frequency == 0)

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
                CKPT.save_checkpoint(
                    cfg.checkpoint_dir, "best_model", leaves=_param_leaves(model),
                    manifest=dict(config=model_cfg.to_dict(), model_type=cfg.model_type,
                                  eval_avg_score=best_eval_avg, train_step=train_step))
                logger.print(f"New best model saved (avg score: {best_eval_avg:.1f}) "
                             f"to {cfg.checkpoint_dir}/best_model.npz")

        if cfg.checkpoint_freq and train_step > 0 and train_step % cfg.checkpoint_freq == 0:
            save_train_state(train_step)
        if on_step is not None:
            on_step(dict(step=train_step, model=model, opt_state=opt_state,
                         moments=moments, traj=traj, scalars=sc,
                         rollout_s=t1 - t0, learner_s=t2 - t1))

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
    logger.close()
    return dict(model=model, moments=moments, highest_score=highest_score,
                emas=emas, env_steps_total=env_steps_total, elapsed=elapsed,
                best_eval_avg=best_eval_avg, current_beta=current_beta)
