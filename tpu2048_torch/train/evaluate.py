"""Standalone evaluation of a checkpoint (counterpart of
``tpu2048/train/evaluate.py``: ``load_model_checkpoint``, ``run_eval`` and
``evaluate_checkpoint``).

MLP checkpoints only; URM checkpoints and expectimax search are not yet
ported and raise.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..algo.rollout import play
from ..env import engine
from ..models.mlp import GameMLP, MLPConfig
from . import checkpoint as CKPT


def load_model_checkpoint(path, device: str | torch.device = "cuda") -> tuple:
    """(model in eval mode on ``device``, model config, model type) from a
    checkpoint directory written by the JAX train loop: ``best_model`` when
    there is one, else the params of ``train_state``."""
    p = Path(path)
    if not p.is_dir():
        raise FileNotFoundError(f"No checkpoint at {path}")
    device = resolve_device(device)
    name = "best_model" if CKPT.checkpoint_exists(p, "best_model") else "train_state"
    arrays, manifest = CKPT.read_npz(p / f"{name}.npz")
    if manifest is None:  # older file: only the .json mirror has it
        with open(p / f"{name}.json") as f:
            manifest = json.load(f)
    if "model_config" in manifest:  # train_state manifest
        cfg_dict = manifest["model_config"]
        model_type = manifest.get(
            "model_type", manifest.get("config", {}).get("model_type", "mlp"))
    else:  # best_model manifest: its config is the model config
        cfg_dict = manifest.get("config", {})
        model_type = manifest.get("model_type", "mlp")
    if model_type != "mlp":
        raise NotImplementedError(
            f"{model_type!r} checkpoints are not yet ported in tpu2048_torch "
            "(MLP only)")
    config = MLPConfig(**cfg_dict)
    model = GameMLP(config)
    names = [k for k, _ in model.named_parameters()]
    model.load_state_dict(CKPT.state_dict_from_arrays(arrays, names, p / f"{name}.npz"))
    return model.to(device).eval(), config, model_type


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
    scores = res.total_points.cpu().numpy()
    tiles = engine.max_tile_value(res.final_board).cpu().numpy()
    return dict(
        max_score=int(scores.max()),
        avg_score=float(scores.mean()),
        median_score=float(np.sort(scores)[len(scores) // 2]),
        pct_512=float((tiles >= 512).mean() * 100),
        pct_1024=float((tiles >= 1024).mean() * 100),
        pct_2048=float((tiles >= 2048).mean() * 100),
        scores=scores.tolist(),
        steps=res.steps,
    )


def evaluate_checkpoint(path, games: int = 100, seed: int = 0,
                        greedy: bool = False, env_seed: int = 12345,
                        search: bool = False,
                        device: str | torch.device = "cuda") -> dict:
    """Load ``path``, evaluate it and print the reference's two result lines."""
    if search:
        raise NotImplementedError("search not yet ported in tpu2048_torch")
    model, _, _ = load_model_checkpoint(path, device)
    print(f"Evaluating model from: {path}")
    print(f"Running {games} evaluation games...")
    m = run_eval(model, games, seed=seed, greedy=greedy, env_seed=env_seed)
    print(f"Eval Results - Max: {m['max_score']}, Avg: {m['avg_score']:.1f}, "
          f"Median: {m['median_score']:.0f}")
    print(f"Tiles Reached - 512: {m['pct_512']:.1f}%, 1024: {m['pct_1024']:.1f}%, "
          f"2048: {m['pct_2048']:.1f}%")
    return m
