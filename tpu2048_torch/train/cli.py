"""CLI of the port: ``evaluate`` (the one subcommand ported so far).

    python -m tpu2048_torch.train.cli evaluate <checkpoint dir> --games N \
        [--greedy] [--seed S] [--env-seed S] [--device cuda|cpu] \
        [--search [--search-depth 1|2|3] [--search-prune K] [--search-bf16]]

Flags as in ``tpu2048/train/cli.py``'s ``evaluate``, plus ``--device``.
"""

from __future__ import annotations

import argparse


def cmd_evaluate(args) -> None:
    from .evaluate import evaluate_checkpoint

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
    p_eval.set_defaults(fn=cmd_evaluate)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
