"""JSON exporters of an episode (counterpart of
``tpu2048/utils/viz_export.py``; the same JSON, key order included).

 * ``export_episode_visualization``: the replay JSON of one train step that
   ``viz_server.py`` and its frontend read, ``step_<NNNNNN>.json``: grids as
   tile values, each move's weighted reward over all nine components (the
   ones inert in training included), entropy and advantage.
 * ``export_best_game``: the browser demo's ``best_game.json``.
"""

from __future__ import annotations

import json
from pathlib import Path

from .. import DIRECTION_NAMES


def _grid_values(grid):
    return [[2**c if c > 0 else 0 for c in row] for row in grid]


def export_episode_visualization(viz_dir, train_step: int, episode: dict,
                                 weights, discount_rate: float) -> Path:
    d = Path(viz_dir)
    d.mkdir(parents=True, exist_ok=True)
    moves = episode.get("moves", [])
    data = {
        "step": train_step,
        "score": episode.get("total_points", 0),
        "total_steps": episode.get("total_steps", len(moves)),
        "moves": [],
    }
    for i, m in enumerate(moves):
        data["moves"].append(
            {
                "step": i + 1,
                "state_before": _grid_values(m.get("state_before", [])),
                "action": DIRECTION_NAMES[m["selected_direction"]],
                "state_after": _grid_values(m.get("result_state", [])),
                "points_earned": m.get("points_earned", 0),
                "rewards": {
                    "points": m.get("points_earned", 0) * weights.points,
                    "smoothness": m.get("smoothness_delta", 0) * weights.smoothness,
                    "tile_bonus": m.get("max_tile_created", 0) * weights.max_tile,
                    "corner": m.get("corner_delta", 0) * weights.corner,
                    "adjacency": m.get("adjacency_delta", 0) * weights.adjacency,
                    "chain": m.get("chain_delta", 0) * weights.chain,
                    "monotonicity": (
                        discount_rate * m.get("monotonicity_after", 0)
                        - m.get("monotonicity_before", 0)
                    ) * weights.monotonicity,
                    "topological": m.get("topological_delta", 0) * weights.topological,
                    "emptiness": (
                        discount_rate * m.get("emptiness_after", 0)
                        - m.get("emptiness_before", 0)
                    ) * weights.emptiness,
                },
                "entropy": m.get("entropy", 0.0),
                "advantage": m.get("advantage", 0.0),
            }
        )
    out = d / f"step_{train_step:06d}.json"
    with open(out, "w") as f:
        json.dump(data, f, indent=2)
    return out


def export_best_game(episode: dict, output_path, meta: dict | None = None) -> Path:
    """Demo replay JSON: states as tile values, 1-indexed steps.

    ``meta`` (optional) is recorded verbatim under a ``play`` key — the
    export provenance (sampled vs search play, depth, seed, games played),
    so the committed showcase artifact says how it was generated."""
    out = Path(output_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    moves = episode.get("moves", [])
    data = {
        "score": episode.get("total_points", 0),
        "total_steps": episode.get("total_steps", len(moves)),
        **({"play": meta} if meta else {}),
        "moves": [
            {
                "step": i + 1,
                "state_before": _grid_values(m.get("state_before", [])),
                "action": DIRECTION_NAMES[m["selected_direction"]],
                "state_after": _grid_values(m.get("result_state", [])),
                "points_earned": m.get("points_earned", 0),
                "entropy": m.get("entropy", 0.0),
            }
            for i, m in enumerate(moves)
        ],
    }
    with open(out, "w") as f:
        json.dump(data, f, indent=2)
    print(
        f"Exported best game ({data['score']} points, {data['total_steps']} moves) to {out}"
    )
    return out
