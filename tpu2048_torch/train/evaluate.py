"""Standalone evaluation of a checkpoint (counterpart of
``tpu2048/train/evaluate.py``: ``load_model_checkpoint``, ``run_eval``,
``load_search_coefs``, ``run_search_eval``, ``evaluate_checkpoint``, and
the demo export's best-of-N play, ``play_best_of`` and
``search_play_best``).

MLP and URM checkpoints; greedy, sampled, or by expectimax search.
"""

from __future__ import annotations

import json
import sys
import zipfile
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..algo.rollout import play, rollout
from ..algo.search import BF16Leaves, SearchCoefs, expectimax_scores
from ..env import engine
from ..models.mlp import GameMLP, MLPConfig
from ..models.urm import GameURM, URMConfig
from . import checkpoint as CKPT

_MODELS = {"mlp": (MLPConfig, GameMLP), "urm": (URMConfig, GameURM)}


def _manifest(p: Path, name: str) -> tuple:
    """(arrays, manifest) of ``<name>.npz``: the embedded manifest, else the
    ``.json`` mirror (older files have only the mirror)."""
    arrays, manifest = CKPT.read_npz(p / f"{name}.npz")
    if manifest is None:
        with open(p / f"{name}.json") as f:
            manifest = json.load(f)
    return arrays, manifest


def load_model_checkpoint(path, device: str | torch.device = "cuda") -> tuple:
    """(model in eval mode on ``device``, model config, model type) from a
    checkpoint directory written by the JAX train loop: ``best_model`` when
    there is one, else the params of ``train_state``."""
    p = Path(path)
    if not p.is_dir():
        raise FileNotFoundError(f"No checkpoint at {path}")
    device = resolve_device(device)
    name = "best_model" if CKPT.checkpoint_exists(p, "best_model") else "train_state"
    arrays, manifest = _manifest(p, name)
    if "model_config" in manifest:  # train_state manifest
        cfg_dict = manifest["model_config"]
        model_type = manifest.get(
            "model_type", manifest.get("config", {}).get("model_type", "mlp"))
    else:  # best_model manifest: its config is the model config
        cfg_dict = manifest.get("config", {})
        model_type = manifest.get("model_type", "mlp")
    config_cls, model_cls = _MODELS["urm" if model_type == "urm" else "mlp"]
    config = config_cls(**cfg_dict)
    model = model_cls(config)
    names = [k for k, _ in model.named_parameters()]
    model.load_state_dict(CKPT.state_dict_from_arrays(arrays, names, p / f"{name}.npz"))
    return model.to(device).eval(), config, model_type


def _summary(scores: np.ndarray, tiles: np.ndarray) -> dict:
    return dict(
        max_score=int(scores.max()),
        avg_score=float(scores.mean()),
        median_score=float(np.sort(scores)[len(scores) // 2]),
        pct_512=float((tiles >= 512).mean() * 100),
        pct_1024=float((tiles >= 1024).mean() * 100),
        pct_2048=float((tiles >= 2048).mean() * 100),
        scores=scores.tolist(),
    )


def run_eval(model, games: int, seed: int = 0, max_steps: int = 4096,
             greedy: bool = False, env_seed: int = 12345) -> dict:
    """Play ``games`` games on the model's device and summarise them as the
    reference does. ``env_seed`` seeds the spawn stream and ``seed`` the
    action sampling, each through its own ``torch.Generator``."""
    device = next(model.parameters()).device
    env_gen = torch.Generator(device=device).manual_seed(env_seed)
    act_gen = torch.Generator(device=device).manual_seed(seed)
    boards = engine.reset(games, device, generator=env_gen)
    res = play(model, boards, max_steps, env_gen, greedy=greedy,
               action_generator=act_gen)
    m = _summary(res.total_points.cpu().numpy(),
                 engine.max_tile_value(res.final_board).cpu().numpy())
    m["steps"] = res.steps
    return m


def load_search_coefs(path) -> SearchCoefs:
    """SearchCoefs for expectimax eval, tying search scores to the trained
    objective: reward weights and gamma from the train-state config, the
    critic's denormalization (sigma, mu) from its RTG moments, bias-corrected
    for ``train_step`` steps of an EMA with ``rtg_beta``.

    The manifest is read as ``load_model_checkpoint`` reads it: embedded in
    ``train_state.npz`` first, the ``.json`` mirror second (the JAX package
    reads only the mirror, and falls back where only the embedded one is
    there). A missing or unreadable train_state falls back, with a loud
    warning on stderr, to pure normalized-EV search (``SearchCoefs()``);
    any other error propagates."""
    p = Path(path)
    try:
        arrays, manifest = _manifest(p, "train_state")
        mu = float(arrays["['moments'].mu"])
        m2 = float(arrays["['moments'].m2"])
        cfg = manifest.get("config", {}) or {}
        beta = float(cfg.get("rtg_beta", 0.99))
        step = int(manifest.get("train_step", 0))
        corr = max(1.0 - beta ** max(step, 1), 1e-8)
        mu_hat = mu / corr
        sigma = float(np.sqrt(max(m2 / corr - mu_hat ** 2, 1e-12)))
        return SearchCoefs(
            points=float(cfg.get("points_weight", 0.1)),
            mono=float(cfg.get("monotonicity_weight", 0.0)),
            empt=float(cfg.get("emptiness_weight", 0.0)),
            sigma=sigma, mu=float(mu_hat),
            gamma=float(cfg.get("gamma", 0.99)))
    except (FileNotFoundError, KeyError, json.JSONDecodeError,
            zipfile.BadZipFile, ValueError, CKPT.CheckpointCorruptError) as e:
        # A corrupted or renamed train_state must not silently degrade the
        # search (pure-EV leaves cost a checkpoint like expA about 15k avg
        # at depth 2 on the JAX package).
        print(f"WARNING: could not load search calibration from {p} "
              f"({type(e).__name__}: {e}); falling back to PURE-EV search "
              f"(uncalibrated critic leaves, no reward shaping) — search "
              f"scores will NOT match the trained objective.",
              file=sys.stderr, flush=True)
        return SearchCoefs()


def _chunk_generator(env_seed: int, chunk: int, device) -> torch.Generator:
    """The spawn stream of chunk ``chunk``: a generator seeded with the first
    64-bit word of ``numpy.random.SeedSequence((env_seed, chunk))``."""
    seed = int(np.random.SeedSequence((env_seed, chunk)).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def run_search_eval(model, games: int, max_steps: int = 4096,
                    env_seed: int = 12345, coefs: SearchCoefs | None = None,
                    depth: int = 1, prune_k: int = 0, bf16: bool = False) -> dict:
    """Expectimax (exact chance nodes, critic leaves) evaluation on the
    model's device, deterministic given the spawn streams.

    Games run in chunks of 256 / 32 / 16 at depth 1 / 2 / >= 3, which bound
    the tree's peak memory (a depth-2 move over N games holds about 16k*N
    leaves). Chunk ``k`` plays its games on its own spawn stream
    (:func:`_chunk_generator` of ``env_seed`` and ``k``), from its own reset.
    Every depth runs the one eager loop, ``algo.rollout.play`` with
    ``search``, which prints a heartbeat every 100 moves; a line per chunk
    goes to stderr. ``prune_k`` bounds the deep fan-out of inner max nodes
    (depth >= 3). ``bf16`` evaluates with :class:`BF16Leaves`."""
    if bf16:
        model = BF16Leaves(model)
    device = next(model.parameters()).device
    coefs = coefs if coefs is not None else SearchCoefs()
    chunk = min(games, 256 if depth <= 1 else (32 if depth == 2 else 16))
    n_chunks = (games + chunk - 1) // chunk
    scores_l, tiles_l, steps = [], [], 0
    for k in range(n_chunks):
        n = min(chunk, games - k * chunk)
        gen = _chunk_generator(env_seed, k, device)
        boards = engine.reset(n, device, generator=gen)
        res = play(model, boards, max_steps, gen, greedy=True,
                   search=(coefs, depth, prune_k))
        scores_l.append(res.total_points.cpu().numpy())
        tiles_l.append(engine.max_tile_value(res.final_board).cpu().numpy())
        steps += res.steps
        done_sc = np.concatenate(scores_l)
        print(f"  [search eval] chunk {k + 1}/{n_chunks} done: "
              f"{len(done_sc)}/{games} games, running avg {done_sc.mean():.0f}, "
              f"max {done_sc.max()}", file=sys.stderr, flush=True)
    m = _summary(np.concatenate(scores_l), np.concatenate(tiles_l))
    m["steps"] = steps
    return m


def play_best_of(model, num_games: int = 10, seed: int = 0, max_steps: int = 4096, *,
                 boards: torch.Tensor | None = None, actions: torch.Tensor | None = None,
                 spawns: torch.Tensor | None = None) -> dict:
    """Play ``num_games`` sampled games (the exact ``rollout``) on the
    model's device and return the best as the host dict the demo exporter
    reads (``loop.fetch_episode``). The fresh boards and spawns come from a
    generator seeded from ``(seed, 0)``, the actions from one seeded from
    ``(seed, 1)``; a test injects ``boards``, ``actions`` and ``spawns``
    instead (``rollout``'s arguments)."""
    from .loop import fetch_episode, make_generator

    device = next(model.parameters()).device
    traj = rollout(model, num_games, max_steps,
                   env_generator=make_generator(device, seed, 0),
                   action_generator=make_generator(device, seed, 1),
                   boards=boards, actions=actions, spawns=spawns)
    scores = traj.total_points.cpu().numpy()
    tiles = engine.max_tile_value(traj.final_board.to(torch.int32)).cpu().numpy()
    order = np.argsort(scores)[::-1]
    print(f"Played {num_games} games — avg: {scores.mean():.0f}, "
          f"best: {scores[order[0]]}, worst: {scores[order[-1]]}")
    print(f"Max tiles reached: {sorted(set(tiles.tolist()), reverse=True)}")
    return fetch_episode(traj, None, int(order[0]))


@torch.inference_mode()
def search_play_best(model, num_games: int = 64, env_seed: int = 12345,
                     coefs: SearchCoefs | None = None, depth: int = 1,
                     max_steps: int = 4096, *, boards: torch.Tensor | None = None,
                     spawns: torch.Tensor | None = None) -> dict:
    """Play ``num_games`` games in lockstep by expectimax (the argmax of
    ``expectimax_scores`` at ``depth``) and return the best as the host dict
    the demo exporter reads; entropy is 0, search play being deterministic.

    One move at a time, every transition recorded on the device, copied to
    the host once at the end; the host reads one flag a move (is any game
    still moving). The fresh boards and the spawns come from a generator
    seeded by ``env_seed``, or from ``boards`` (N, 4, 4) and ``spawns``
    (max_steps, 2, N). A game that has ended has no legal move, so the step
    leaves its board as it was: the ended boards stay frozen."""
    device = next(model.parameters()).device
    coefs = coefs if coefs is not None else SearchCoefs()
    gen = None if spawns is not None else torch.Generator(device=device).manual_seed(env_seed)
    if boards is None:
        boards = engine.reset(num_games, device, generator=gen)
    moves = engine.all_moves(boards)
    alive = torch.ones(num_games, dtype=torch.bool, device=device)
    points = torch.zeros(num_games, dtype=torch.int64, device=device)
    nmoves = torch.zeros(num_games, dtype=torch.int32, device=device)
    recs = []  # (boards, action, new boards, reward, step_alive) a move
    for t in range(max_steps):
        action = expectimax_scores(model, boards, moves, coefs, depth).argmax(-1)
        draws = (spawns[t] if spawns is not None
                 else engine.spawn_draws((num_games,), gen, device))
        res = engine.step(boards, action, draws, moves=moves)
        step_alive = alive & moves.any_legal
        if not bool(step_alive.any()):
            break
        reward = torch.where(step_alive, res.reward, 0)
        recs.append((boards, action, res.board, reward, step_alive))
        points += reward
        nmoves += step_alive.to(torch.int32)
        alive = step_alive & ~res.done
        boards, moves = res.board, res.moves
    points, nmoves = points.cpu().numpy(), nmoves.cpu().numpy()
    best = int(points.argmax())
    tiles = engine.max_tile_value(boards).cpu().numpy()
    print(f"Search-played {num_games} games (depth={depth}) — "
          f"avg: {points.mean():.0f}, best: {points[best]}, "
          f"max tile: {int(tiles.max())}")
    lane = ([torch.stack(f)[:, best].cpu().numpy() for f in zip(*recs)] if recs
            else [[]] * 5)
    moves_out = [
        {
            "selected_direction": int(a),
            "state_before": b.astype(int).tolist(),
            "result_state": nb.astype(int).tolist(),
            "points_earned": int(r),
            "entropy": 0.0,
        }
        for b, a, nb, r, sa in zip(*lane) if sa
    ]
    return {
        "moves": moves_out,
        "total_points": int(points[best]),
        # The reference's count: total_steps == len(moves) - 1 for a game
        # that ended.
        "total_steps": max(int(nmoves[best]) - 1, 0),
        "final_state": boards[best].cpu().numpy().astype(int).tolist(),
    }


def evaluate_checkpoint(path, games: int = 100, seed: int = 0,
                        greedy: bool = False, env_seed: int = 12345,
                        search: bool = False, search_depth: int = 1,
                        search_prune: int = 0, search_bf16: bool = False,
                        device: str | torch.device = "cuda") -> dict:
    """Load ``path``, evaluate it and print the reference's result lines."""
    model, _, _ = load_model_checkpoint(path, device)
    print(f"Evaluating model from: {path}")
    print(f"Running {games} evaluation games...")
    if search:
        coefs = load_search_coefs(path)
        prune_note = f", prune_k={search_prune}" if search_prune else ""
        print(f"Expectimax search eval (depth={search_depth}{prune_note}, "
              f"points={coefs.points:.3g}, mono={coefs.mono:.3g}, "
              f"empt={coefs.empt:.3g}, sigma={coefs.sigma:.3g}, "
              f"mu={coefs.mu:.3g}, gamma={coefs.gamma:.3g})")
        m = run_search_eval(model, games, env_seed=env_seed, coefs=coefs,
                            depth=search_depth, prune_k=search_prune,
                            bf16=search_bf16)
    else:
        m = run_eval(model, games, seed=seed, greedy=greedy, env_seed=env_seed)
    print(f"Eval Results - Max: {m['max_score']}, Avg: {m['avg_score']:.1f}, "
          f"Median: {m['median_score']:.0f}")
    print(f"Tiles Reached - 512: {m['pct_512']:.1f}%, 1024: {m['pct_1024']:.1f}%, "
          f"2048: {m['pct_2048']:.1f}%")
    return m
