"""CLI of the port: ``evaluate`` (the one subcommand ported so far).

    python -m tpu2048_torch.train.cli evaluate <checkpoint dir> --games N \
        [--greedy] [--seed S] [--env-seed S] [--device cuda|cpu]

Flags as in ``tpu2048/train/cli.py``'s ``evaluate``, plus ``--device``.
"""

from __future__ import annotations

import argparse


def cmd_evaluate(args) -> None:
    from .evaluate import evaluate_checkpoint

    evaluate_checkpoint(args.model_path, games=args.games, seed=args.seed,
                        greedy=args.greedy, env_seed=args.env_seed,
                        device=args.device)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="tpu2048_torch",
        description="Evaluate 2048 agents with the PyTorch/CUDA port")
    sub = parser.add_subparsers(dest="command", required=True)

    p_eval = sub.add_parser("evaluate", help="Evaluate a trained agent")
    p_eval.add_argument("model_path", help="Path to checkpoint directory")
    p_eval.add_argument("--games", "-g", type=int, default=100)
    p_eval.add_argument("--seed", type=int, default=0,
                        help="Seed of the action-sampling generator")
    p_eval.add_argument("--greedy", action="store_true",
                        help="Argmax actions instead of sampling")
    p_eval.add_argument("--env-seed", dest="env_seed", type=int, default=12345,
                        help="Seed of the fixed eval env stream")
    p_eval.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the plain "
                             "merge instead of the CUDA kernel)")
    p_eval.set_defaults(fn=cmd_evaluate)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
