#!/usr/bin/env python3
"""Prune-bias check on the port (counterpart of ``scripts/prune_bias.py``):
how often does top-k pruning of the inner max nodes change the chosen move,
and by how much does it move the root scores?

    python3 scripts/torch_prune_bias.py [ckpt] [n_boards] [depth] [--device cuda|cpu]

Defaults: ``checkpoints_expA``, 64 boards, depth 3. Inner max nodes exist
only at depth >= 3 (``algo/search.py::state_values``: at depth 2 the
recursive calls run at depth 1, below the pruning gate), so the comparison
that means something is at depth 3: ``expectimax_scores(depth=3,
prune_k=0)`` (the exact inner max, (4*32)^3 = 2,097,152 critic leaves a
board) against ``prune_k`` 2 and 3.

The boards are sampled from the checkpoint's own greedy games, as the JAX
script samples them: 64 games of at most 512 moves from the spawn seed 99,
``numpy.random.default_rng(0)`` picking ``n_boards`` of their recorded
states without replacement. The spawn streams are the port's
(``torch.Generator``), so the boards are not the JAX script's.

Memory. The search loops over spawn slots (one slot of each chance node at
a time), so what is in flight at once is the deepest chance node's
children: 4^depth * 32 leaves a board (2,048 at depth 3), each with its
merge outputs, encoding and activations, estimated at ``leaf_bytes``. The
boards go in chunks sized so that the estimate stays within ``CAP_MIB``
(4,096 MiB); the cap, the chunk and, on a card, the measured peak
above the memory held before the search (``torch.cuda.max_memory_allocated``)
are printed.

Prints, for each k, the changed moves (argmax over the legal moves, the
pruned search's against the exact one's), the agreement, and the
distribution of |score shift| over the legal moves: mean (also in units of
the checkpoint's sigma), p95 and max. On ``cuda`` unless ``--device cpu``;
without a card ``cuda`` raises. Imports torch, numpy and the port only.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from tpu2048_torch.algo import rollout as R  # noqa: E402
from tpu2048_torch.algo.search import NUM_SPAWNS, expectimax_scores  # noqa: E402
from tpu2048_torch.env import engine  # noqa: E402
from tpu2048_torch.train.evaluate import load_model_checkpoint, load_search_coefs  # noqa: E402

GAMES, GAME_CAP, ENV_SEED, PICK_SEED = 64, 512, 99, 0  # the JAX script's sampling
PRUNE_KS = (2, 3)
CAP_MIB = 4096  # bound on the search's estimated memory in flight


def greedy_boards(model, n: int, games: int = GAMES, max_steps: int = GAME_CAP,
                  env_seed: int = ENV_SEED, pick_seed: int = PICK_SEED) -> np.ndarray:
    """(min(n, recorded states), 4, 4) int32 boards sampled uniformly
    without replacement from ``games`` greedy games of ``model``."""
    device = next(model.parameters()).device
    traj = R.rollout(model, games, max_steps, greedy=True,
                     env_generator=torch.Generator(device=device).manual_seed(env_seed))
    valid = traj.valid.reshape(-1).cpu().numpy()
    boards = traj.board_before.reshape(-1, 4, 4).cpu().numpy()[valid].astype(np.int32)
    rng = np.random.default_rng(pick_seed)
    return boards[rng.choice(len(boards), size=min(n, len(boards)), replace=False)]


def leaves_in_flight(depth: int) -> int:
    """Critic leaves a board has in flight at once: the children of one
    spawn slot path's deepest chance node, over every action below it."""
    return 4 ** depth * NUM_SPAWNS


def leaf_bytes(hidden: int) -> int:
    """An estimate of a leaf's bytes at once, about twice what the tensors
    take: the child board (64 B), its four merged boards and their scores
    and flags (about 300 B), its encoding (192 B) and a few (hidden,)
    float32 activations of the forward."""
    return 1024 + 32 * hidden


def chunk_boards(depth: int, hidden: int, cap_bytes: int) -> int:
    """Boards a chunk may hold so that the estimate stays within
    ``cap_bytes`` (at least 1)."""
    return max(1, cap_bytes // (leaves_in_flight(depth) * leaf_bytes(hidden)))


def root_scores(model, boards: np.ndarray, coefs, depth: int, prune_k: int,
                chunk: int) -> np.ndarray:
    """(B, 4) float32 ``expectimax_scores`` of ``boards`` on the model's
    device, ``chunk`` boards a call; -inf where illegal."""
    device = next(model.parameters()).device
    out = []
    with torch.inference_mode():
        for i in range(0, len(boards), chunk):
            b = torch.as_tensor(boards[i:i + chunk], device=device)
            out.append(expectimax_scores(model, b, None, coefs, depth, prune_k).cpu().numpy())
    return np.concatenate(out)


def compare(exact: np.ndarray, pruned: np.ndarray, legal: np.ndarray, sigma: float) -> dict:
    """The pruned search's moves and scores against the exact one's: the
    changed moves (first argmax over the legal moves), the agreement, and
    |shift| over the entries finite in both."""
    ex = np.where(legal, exact, -np.inf)
    pr = np.where(legal, pruned, -np.inf)
    changed = int((ex.argmax(-1) != pr.argmax(-1)).sum())
    finite = np.isfinite(ex) & np.isfinite(pr)
    dev = np.abs(ex[finite] - pr[finite]).astype(np.float64)
    return dict(boards=len(ex), changed=changed, agreement=1.0 - changed / len(ex),
                shift_mean=float(dev.mean()), shift_mean_sigma=float(dev.mean() / sigma),
                shift_p95=float(np.percentile(dev, 95)), shift_max=float(dev.max()))


def prune_bias(ckpt, n: int = 64, depth: int = 3, device: str = "cuda",
               boards: np.ndarray | None = None, say=print) -> dict:
    """The check on ``n`` boards of ``ckpt``'s greedy games (or the given
    ``boards``): the exact and each pruned search's root scores, their
    comparison by k, the chunk, the cap and (on a card) the peak."""
    model, mcfg, _ = load_model_checkpoint(str(ckpt), device=device)
    coefs = load_search_coefs(str(ckpt))
    dev = next(model.parameters()).device
    if boards is None:
        boards = greedy_boards(model, n)
        source = f"from greedy games, ckpt {ckpt}"
    else:
        source = f"given, ckpt {ckpt}"
    boards = np.asarray(boards, np.int32)
    cap = CAP_MIB << 20
    chunk = chunk_boards(depth, mcfg.hidden_dim, cap)
    legal = engine.all_moves(torch.as_tensor(boards, device=dev)).legal.T.cpu().numpy()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    exact = root_scores(model, boards, coefs, depth, 0, chunk)
    exact_s = time.perf_counter() - t0
    pruned, stats, seconds = {}, {}, {}
    for k in PRUNE_KS:
        t1 = time.perf_counter()
        pruned[k] = root_scores(model, boards, coefs, depth, k, chunk)
        seconds[k] = time.perf_counter() - t1
        stats[k] = compare(exact, pruned[k], legal, coefs.sigma)
    peak = (torch.cuda.max_memory_allocated(dev) - base) if dev.type == "cuda" else None
    say(f"boards sampled: {len(boards)} ({source}), depth={depth}: exact (prune 0) vs "
        f"pruned inner max")
    say(f"peak memory cap {CAP_MIB} MiB: chunks of {chunk} boards ({leaves_in_flight(depth)} "
        f"leaves a board in flight, estimated {leaf_bytes(mcfg.hidden_dim)} B each); "
        + (f"measured peak {peak / 2 ** 20:.1f} MiB above the {base / 2 ** 20:.1f} MiB held "
           f"before ({torch.cuda.get_device_name(dev)})" if peak is not None
           else "peak not measured (cpu)"))
    say(f"exact search {exact_s:.3f} s")
    for k, s in stats.items():
        say(f"prune_k={k}: changed moves {s['changed']}/{s['boards']}, argmax agreement "
            f"{s['agreement'] * 100:.2f}%  |score dev| mean {s['shift_mean']:.4f} "
            f"(={s['shift_mean_sigma']:.4f} sigma), p95 {s['shift_p95']:.4f}, "
            f"max {s['shift_max']:.4f}; {seconds[k]:.3f} s")
    return dict(boards=boards, legal=legal, exact=exact, pruned=pruned, stats=stats,
                chunk=chunk, cap_bytes=cap, peak_bytes=peak, exact_s=exact_s,
                pruned_s=seconds, sigma=coefs.sigma)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ckpt", nargs="?", default="checkpoints_expA")
    ap.add_argument("n_boards", nargs="?", type=int, default=64)
    ap.add_argument("depth", nargs="?", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    return prune_bias(args.ckpt, args.n_boards, args.depth, args.device,
                      say=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
