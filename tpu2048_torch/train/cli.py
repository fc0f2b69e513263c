"""CLI of the port: ``train`` (the trainer, MLP or URM, exact-episodes or
packed, PPO or expert iteration, on one device or data-parallel),
``evaluate``, ``export-demo`` (the ``web/`` demo's assets), ``human`` and
``play`` (the terminal clients). ``bench`` (the JAX package's ``bench.py``)
is not ported.

    python -m tpu2048_torch.train.cli train --packed --lanes 512 \
        --horizon 256 --batch-size 4096 ... [--viz-dir DIR] \
        [--resume] [--device cuda|cpu]
    python -m tpu2048_torch.train.cli train --episodes 512 \
        --batch-size 4096 -H 196 ... [--resume] [--device cuda|cpu]
    python -m tpu2048_torch.train.cli train --episodes 32 ... --expert-iter \
        --expert-depth 2 [--expert-src DIR] [--expert-bf16] [--anchor-kl S]
    python -m tpu2048_torch.train.cli train ... --mesh-data D [--device cpu]
    python -m tpu2048_torch.train.cli train ... --coordinator-address A \
        --num-processes P --process-id i [--mesh-data D]   (on every host)
    python -m tpu2048_torch.train.cli evaluate <checkpoint dir> --games N \
        [--greedy] [--seed S] [--env-seed S] [--device cuda|cpu] \
        [--search [--search-depth 1|2|3] [--search-prune K] [--search-bf16]]
    python -m tpu2048_torch.train.cli export-demo --model <checkpoint dir> \
        [--output web/data] [-n N] [--seed S] [--search [--search-depth 1|2]] \
        [--game best_game.json] [--device cuda|cpu]
    python -m tpu2048_torch.train.cli play [--model DIR] [--delay S] \
        [--seed S] [--search 0|1|2] [--device cuda|cpu]
    python -m tpu2048_torch.train.cli human [--seed S] [--device cuda|cpu]

Flags as in ``tpu2048/train/cli.py`` (same names and defaults), plus
``--device``. ``--wandb`` raises ``NotImplementedError``; so does
``--platform``, the JAX package's device switch.
"""

from __future__ import annotations

import argparse


def _add_train_flags(p: argparse.ArgumentParser) -> None:
    add = p.add_argument
    add("--steps", "-s", type=int, default=1000, help="Number of training steps")
    add("--model", "-m", dest="model_path", default=None,
        help="Resume training from a train-state checkpoint directory")
    add("--lr", dest="learning_rate", type=float, default=0.001)
    add("--gamma", type=float, default=0.99, help="Discount factor")
    add("--entropy", dest="entropy_strength", type=float, default=0.1)
    add("--critic", dest="critic_strength", type=float, default=1.0)
    add("--epsilon", type=float, default=1.0, help="(unused, kept for parity)")
    add("--momentum", type=float, default=0.99, help="(unused, kept for parity)")
    add("--episodes", dest="num_episodes", type=int, default=1)
    add("--batch-size", dest="batch_size", type=int, default=1)
    add("--epochs", dest="ppo_epochs", type=int, default=1)
    add("--workers", "-w", type=int, default=1,
        help="(unused: rollouts are batched on the device)")
    add("--max-steps", dest="max_steps", type=int, default=None)
    add("--hidden", "-H", dest="hidden_size", type=int, default=64)
    add("--num-layers", "-l", dest="num_layers", type=int, default=2)
    add("--model-type", "-t", dest="model_type", default="mlp")
    add("--num-heads", dest="num_heads", type=int, default=4)
    add("--num-loops", dest="num_loops", type=int, default=4)
    add("--truncated-loops", dest="num_truncated_loops", type=int, default=1)
    add("--print-freq", "-p", dest="print_frequency", type=int, default=10)
    add("--show-last-steps", dest="show_last_steps", type=int, default=0)
    add("--points", dest="points_weight", type=float, default=0.0)
    add("--smoothness", dest="smoothness_weight", type=float, default=0.0)
    add("--tile-bonus", dest="max_tile_weight", type=float, default=0.0)
    add("--corner", dest="corner_weight", type=float, default=0.0)
    add("--adjacency", dest="adjacency_weight", type=float, default=0.0)
    add("--chain", dest="chain_weight", type=float, default=0.0)
    add("--mono", dest="monotonicity_weight", type=float, default=0.0)
    add("--warmup-steps", dest="warmup_steps", type=int, default=200)
    add("--emptiness", dest="emptiness_weight", type=float, default=0.0)
    add("--topo", dest="topological_weight", type=float, default=0.0)
    add("--win-bonus", dest="win_bonus", type=float, default=0.0)
    add("--gpu", action="store_true",
        help="(accepted for parity; the device is --device)")
    add("--viz-dir", dest="viz_dir", default=None)
    add("--rtg-beta", dest="rtg_beta", type=float, default=0.9)
    add("--log-dir", dest="log_dir", default=None)
    add("--wandb", dest="use_wandb", action="store_true")
    add("--wandb-project", dest="wandb_project", default="2048-rl")
    add("--wandb-run", dest="wandb_run_name", default=None)
    add("--eval-freq", dest="eval_freq", type=int, default=None)
    add("--eval-games", dest="eval_games", type=int, default=100)
    add("--critic-lr", dest="critic_lr", type=float, default=0.001)
    add("--decouple-critic", dest="decouple_critic", action="store_true")
    add("--upsample-ratio", dest="upsample_ratio", type=float, default=0.0)
    add("--export-demo", dest="export_demo", action="store_true")
    add("--checkpoint-dir", dest="checkpoint_dir", default="checkpoints")
    add("--beta1", type=float, default=0.9)
    add("--beta2", type=float, default=0.999)
    add("--weight-decay", dest="weight_decay", type=float, default=0.01)
    add("--adaptive-beta", dest="adaptive_beta", action="store_true")
    add("--target-entropy", dest="target_entropy", type=float, default=0.7)
    add("--beta-min", dest="beta_min", type=float, default=0.001)
    add("--beta-max", dest="beta_max", type=float, default=1.0)
    add("--beta-lr", dest="beta_lr", type=float, default=0.01)
    add("--seed", type=int, default=0, help="Seed of the run's generators")
    add("--resume", action="store_true", help="Resume from checkpoint-dir")
    add("--no-kl-diagnostic", dest="kl_diagnostic", action="store_false",
        help="Skip the per-minibatch KL(old||new) extra forward")
    add("--scan-cap", dest="scan_cap", type=int, default=4096,
        help="Episode-length capacity: the most moves of an exact-mode or "
             "eval-in-train game, and the packed recorder's episode buffer")
    add("--packed", action="store_true",
        help="Packed (auto-reset) rollout: persistent lanes advance a fixed "
             "number of steps per train step, finished games reset in place "
             "and episodes cut at the chunk boundary are value-bootstrapped; "
             "without it, each step plays --episodes games to their ends")
    add("--lanes", type=int, default=0,
        help="Packed mode: number of persistent env lanes (0 -> --episodes)")
    add("--horizon", type=int, default=512,
        help="Packed mode: env steps per lane per train step")
    add("--no-packed-capture", dest="packed_capture", action="store_false",
        default=True,
        help="Packed mode: no best-episode recorder (algo/capture.py), "
             "which feeds the breakdown and the viz JSON; saves lanes x "
             "scan-cap x 41 B of device memory")
    add("--checkpoint-freq", dest="checkpoint_freq", type=int, default=None)
    add("--mesh-data", dest="mesh_data", type=int, default=1,
        help="Data-parallel ranks (> 1: one process a rank, NCCL between "
             "cards, Gloo on the CPU; lanes/episodes and batch are global)")
    add("--dropout", type=float, default=0.1)
    add("--eval-env-seed", dest="eval_env_seed", type=int, default=12345,
        help="Base seed of the spawn stream of eval-in-train")
    add("--eval-fixed-stream", dest="eval_fixed_stream", action="store_true",
        help="The same eval spawn stream every round instead of one per "
             "round")
    add("--no-pipeline", dest="pipeline", action="store_false", default=True,
        help="Accepted for parity; has no effect here: the host enqueues "
             "each eager step as it runs it and reads the step's scalars "
             "once, after all of its work is enqueued")
    add("--expert-iter", dest="expert_iter", action="store_true",
        help="Expert iteration: an expectimax teacher labels every state of "
             "exact-episode rollouts and drives --expert-mix of the games; the "
             "policy trains on the imitation objective")
    add("--expert-depth", dest="expert_depth", type=int, default=1, choices=(1, 2))
    add("--expert-mix", dest="expert_mix", type=float, default=0.5)
    add("--expert-tau", dest="expert_tau", type=float, default=0.02)
    add("--no-expert-sharp", dest="expert_sharp", action="store_false", default=True)
    add("--expert-src", dest="expert_src", default=None)
    add("--expert-bf16", dest="expert_bf16", action="store_true")
    add("--anchor-kl", dest="anchor_kl", type=float, default=0.0,
        help="KL trust region: strength of KL(run-start policy || policy) "
             "added to the loss")
    add("--coordinator-address", dest="coordinator_address", default=None,
        help="host:port of process 0 (multi-host training)")
    add("--num-processes", dest="num_processes", type=int, default=None,
        help="Total number of hosts/processes in the job; each starts "
             "--mesh-data / --num-processes ranks (--mesh-data defaults to it)")
    add("--process-id", dest="process_id", type=int, default=None,
        help="This host's index in [0, num_processes)")
    _add_device_flags(p)


def _add_device_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--platform", default=None,
                   help="The JAX package's platform switch; the port's is --device")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain merge "
                        "instead of the CUDA kernel)")


def check_platform(args) -> None:
    """Refuse the JAX package's ``--platform``: the port's switch is ``--device``."""
    if args.platform:
        raise NotImplementedError(f"--platform {args.platform}: not ported; the "
                                  "port picks its device with --device")


def config_from_args(args):
    """The ``TrainConfig`` of parsed ``train`` arguments; raises
    ``NotImplementedError`` for ``--platform`` (the config's own flags are
    checked by ``train``)."""
    check_platform(args)
    from .loop import TrainConfig

    field_names = set(TrainConfig.__dataclass_fields__)
    kwargs = {k: v for k, v in vars(args).items() if k in field_names}
    if args.model_path:
        kwargs["resume"] = True
        kwargs["checkpoint_dir"] = args.model_path
    return TrainConfig(**kwargs)


def train_config(argv: list):
    """The ``TrainConfig`` that ``train`` with the flags ``argv`` runs."""
    return config_from_args(build_parser().parse_args(["train", *argv]))


def cmd_train(args) -> None:
    cfg = config_from_args(args)
    if cfg.mesh_data > 1 or (args.num_processes or 1) > 1:
        from ..parallel.train_step import launch

        launch(cfg, args.coordinator_address, args.num_processes, args.process_id)
        return
    from .loop import train

    train(cfg)


def cmd_evaluate(args) -> None:
    from .evaluate import evaluate_checkpoint

    check_platform(args)
    if args.search and args.search_depth >= 3 and args.search_prune == 0:
        # The exact depth-3 tree is (4*32)^2 subproblems per move per board:
        # force the tractable default instead of silently wedging.
        print("--search-depth 3 without --search-prune is intractable "
              "(exact (4*32)^2 inner tree); forcing --search-prune 2. "
              "Pass --search-prune explicitly to override.")
        args.search_prune = 2
    evaluate_checkpoint(args.model_path, games=args.games, seed=args.seed,
                        greedy=args.greedy, env_seed=args.env_seed,
                        search=args.search, search_depth=args.search_depth,
                        search_prune=args.search_prune,
                        search_bf16=args.search_bf16, device=args.device)


def cmd_export_demo(args) -> None:
    import json
    import shutil
    from pathlib import Path

    from .evaluate import (load_model_checkpoint, load_search_coefs, play_best_of,
                           search_play_best)
    from .export import export_demo_assets

    check_platform(args)
    model, model_cfg, model_type = load_model_checkpoint(args.model_path, args.device)
    print(f"Model loaded (hidden_dim={model_cfg.hidden_dim}, "
          f"num_layers={model_cfg.num_layers})")
    if args.game_path:
        data = json.loads(Path(args.game_path).read_text())
        out = Path(args.output_dir)
        out.mkdir(parents=True, exist_ok=True)
        demo = {"score": data.get("score", 0),
                "total_steps": data.get("total_steps", len(data.get("moves", []))),
                "moves": data.get("moves", [])}
        (out / "best_game.json").write_text(json.dumps(demo, indent=2))
        print(f"Game exported to {out / 'best_game.json'}")
        best = play_meta = None
    elif args.search:
        coefs = load_search_coefs(args.model_path)
        print(f"Search play for demo export (depth={args.search_depth}, "
              f"coefs={coefs})")
        env_seed = args.seed if args.seed else 12345
        best = search_play_best(model, num_games=args.num_games, env_seed=env_seed,
                                coefs=coefs, depth=args.search_depth)
        play_meta = {"mode": "search", "search_depth": args.search_depth,
                     "num_games": args.num_games, "env_seed": env_seed}
    else:
        best = play_best_of(model, num_games=args.num_games, seed=args.seed)
        play_meta = {"mode": "sampled", "num_games": args.num_games,
                     "seed": args.seed}
    export_demo_assets(model, model_cfg, model_type, best, args.output_dir,
                       search_coefs=load_search_coefs(args.model_path),
                       play_meta=play_meta)
    # The raw checkpoint goes next to the demo assets.
    src_dir = Path(args.model_path)
    name = "best_model" if (src_dir / "best_model.npz").exists() else "train_state"
    for ext in (".npz", ".json"):
        src = src_dir / f"{name}{ext}"
        if src.exists():
            shutil.copy2(src, Path(args.output_dir) / f"best_model{ext}")
    print(f"\nDemo assets exported to {args.output_dir}/")
    print("To test locally: cd web && python -m http.server 8000")


def cmd_human(args) -> None:
    from .play_cli import human_play

    check_platform(args)
    human_play(device=args.device, seed=args.seed)


def cmd_play(args) -> None:
    from .play_cli import watch_agent

    check_platform(args)
    watch_agent(model_path=args.model_path, delay=args.delay, seed=args.seed,
                search=args.search, device=args.device)


def cmd_bench(args) -> None:
    raise NotImplementedError("bench: the JAX package's bench.py is not ported; the "
                              "port's benchmark is a BENCHMARK.json of its own (ROADMAP.md)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="tpu2048_torch",
        description="Train and evaluate 2048 agents with the PyTorch/CUDA port")
    sub = parser.add_subparsers(dest="command", required=True)

    p_train = sub.add_parser("train", help="Train an agent")
    _add_train_flags(p_train)
    p_train.set_defaults(fn=cmd_train)

    p_eval = sub.add_parser("evaluate", help="Evaluate a trained agent")
    p_eval.add_argument("model_path", help="Path to checkpoint directory")
    p_eval.add_argument("--games", "-g", type=int, default=100)
    p_eval.add_argument("--seed", type=int, default=0,
                        help="Seed of the action-sampling generator")
    p_eval.add_argument("--greedy", action="store_true",
                        help="Argmax actions instead of sampling")
    p_eval.add_argument("--env-seed", dest="env_seed", type=int, default=12345,
                        help="Seed of the fixed eval env stream")
    p_eval.add_argument("--search", action="store_true",
                        help="Expectimax action selection (exact chance "
                             "nodes, critic leaves) instead of the raw policy")
    p_eval.add_argument("--search-depth", dest="search_depth", type=int,
                        default=1, choices=(1, 2, 3),
                        help="Max-node plies for --search (2 = exact 2-ply "
                             "tree, 4x32x4x32 leaves per board; 3 needs "
                             "--search-prune to be tractable)")
    p_eval.add_argument("--search-prune", dest="search_prune", type=int,
                        default=0, choices=(0, 1, 2, 3),
                        help="Expand only the top-k actions (ranked by 1-ply "
                             "score) at inner max nodes; 0 = exact tree. "
                             "Only takes effect at depth >= 3 (inner max "
                             "nodes don't exist below that); forced to 2 "
                             "when depth 3 is requested without it")
    p_eval.add_argument("--search-bf16", dest="search_bf16",
                        action="store_true",
                        help="Run the search's critic leaf forwards in "
                             "bfloat16 (as the JAX package runs them: "
                             "bf16-rounded inputs and weights, float32 "
                             "arithmetic; flips only near-tie action choices)")
    _add_device_flags(p_eval)
    p_eval.set_defaults(fn=cmd_evaluate)

    p_exp = sub.add_parser("export-demo", help="Export demo assets for the web UI")
    p_exp.add_argument("--model", "-m", dest="model_path", default="checkpoints",
                       help="Checkpoint dir")
    p_exp.add_argument("--game", "-g", dest="game_path", default=None,
                       help="Export this best_game.json instead of playing")
    p_exp.add_argument("--output", "-o", dest="output_dir", default="web/data")
    p_exp.add_argument("--num-games", "-n", dest="num_games", type=int, default=10)
    p_exp.add_argument("--gpu", action="store_true",
                       help="(accepted for parity; the device is --device)")
    p_exp.add_argument("--batch-size", "-b", type=int, default=32,
                       help="(accepted for parity; unused)")
    p_exp.add_argument("--seed", type=int, default=0,
                       help="Seed of sampled play; of search play's spawns "
                            "when nonzero (else 12345)")
    p_exp.add_argument("--search", action="store_true",
                       help="Generate the showcase game with expectimax "
                            "search play instead of sampled policy play")
    p_exp.add_argument("--search-depth", dest="search_depth", type=int,
                       default=2, choices=(1, 2))
    _add_device_flags(p_exp)
    p_exp.set_defaults(fn=cmd_export_demo)

    p_human = sub.add_parser("human", help="Play 2048 yourself (WASD/arrows)")
    p_human.add_argument("--seed", type=int, default=0, help="Seed of the spawns")
    _add_device_flags(p_human)
    p_human.set_defaults(fn=cmd_human)

    p_play = sub.add_parser("play", help="Watch an agent play")
    p_play.add_argument("--model", "-m", dest="model_path", default=None)
    p_play.add_argument("--delay", "-d", type=float, default=0.5)
    p_play.add_argument("--seed", type=int, default=0,
                        help="Seed of the spawns, the sampled actions and the "
                             "untrained agent's weights")
    p_play.add_argument("--search", type=int, default=0, choices=(0, 1, 2),
                        help="Expectimax move selection of this depth "
                             "(0 = sample the policy)")
    _add_device_flags(p_play)
    p_play.set_defaults(fn=cmd_play)

    p_bench = sub.add_parser("bench", help="The JAX package's throughput benchmark "
                             "(not ported)")
    p_bench.set_defaults(fn=cmd_bench)
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
