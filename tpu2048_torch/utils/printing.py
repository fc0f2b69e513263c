"""Terminal printers of an episode (counterpart of
``tpu2048/utils/printing.py``; the same text, line for line).

A box-drawn grid, the episode's reward breakdown (with the PBRS check
gamma^T * Phi_T - Phi_0) and its last steps' boards. They read the host-side
episode dict that the trainer fetches (``train/loop.py::fetch_episode`` and
``fetch_packed_episode``) and write through the logger's ``print``.
"""

from __future__ import annotations

from .. import DIRECTION_NAMES


def format_grid(grid, indent: str = "  ") -> str:
    """Box-drawn 4x4 grid; cells show tile values (2**exponent)."""
    max_val = max((2**c if c > 0 else 0 for row in grid for c in row), default=0)
    w = max(4, len(str(max_val)) + 1)
    bar = "─" * (w * 4 + 3)
    lines = [indent + "┌" + bar + "┐"]
    for i, row in enumerate(grid):
        cells = [
            (str(2**c) if c > 0 else ".").center(w) for c in row
        ]
        lines.append(indent + "│" + "│".join(cells) + "│")
        if i < 3:
            lines.append(indent + "├" + bar + "┤")
    lines.append(indent + "└" + bar + "┘")
    return "\n".join(lines)


def print_episode_breakdown(logger, episode: dict, weights, gamma: float) -> None:
    """Reward breakdown + PBRS tables for the best episode of a batch.

    ``episode``: dict with 'moves' (list of per-step dicts carrying
    points_earned, smoothness_delta, max_tile_created, corner_delta,
    adjacency_delta, chain_delta, topological_delta, monotonicity_before/after,
    emptiness_before/after), 'total_points', 'total_steps'.
    """
    moves = episode.get("moves", [])
    if not moves:
        return
    logger.print(
        f"\n  Best game this batch (score: {episode['total_points']}, "
        f"steps: {episode['total_steps']}):"
    )

    totals = {
        "points_earned": sum(m.get("points_earned", 0) for m in moves),
        "smoothness": sum(m.get("smoothness_delta", 0) for m in moves),
        "tile_bonus": sum(m.get("max_tile_created", 0) for m in moves),
        "corner": sum(m.get("corner_delta", 0) for m in moves),
        "adjacency": sum(m.get("adjacency_delta", 0) for m in moves),
        "chain": sum(m.get("chain_delta", 0) for m in moves),
        "topological": sum(m.get("topological_delta", 0) for m in moves),
    }
    comp_weights = {
        "points_earned": weights.points,
        "smoothness": weights.smoothness,
        "tile_bonus": weights.max_tile,
        "corner": weights.corner,
        "adjacency": weights.adjacency,
        "chain": weights.chain,
        "topological": weights.topological,
    }

    logger.print("  Reward breakdown:")
    logger.print("    ┌─────────────────┬──────────┬────────┬──────────┐")
    logger.print("    │ Component       │      Raw │ Weight │ Weighted │")
    logger.print("    ├─────────────────┼──────────┼────────┼──────────┤")
    total_weighted = 0.0
    for name, raw in totals.items():
        wt = comp_weights[name]
        weighted = raw * wt
        total_weighted += weighted
        logger.print(f"    │ {name:<15} │ {raw:>8.1f} │ {wt:>6.2f} │ {weighted:>8.1f} │")
    logger.print("    ├─────────────────┼──────────┼────────┼──────────┤")
    logger.print(f"    │ {'TOTAL':<15} │          │        │ {total_weighted:>8.1f} │")
    logger.print("    └─────────────────┴──────────┴────────┴──────────┘")

    if weights.monotonicity != 0.0 or weights.emptiness != 0.0:
        T = len(moves)
        gamma_T = gamma**T
        logger.print("")
        logger.print(f"  PBRS Reward Shaping (γ={gamma:.4f}, T={T}, γ^T={gamma_T:.4f}):")
        logger.print("    ┌─────────────┬──────────┬──────────┬────────┬──────────┐")
        logger.print("    │ Potential   │    Φ(s₀) │   Φ(s_T) │ Weight │ γ^T·Φ_T-Φ₀│")
        logger.print("    ├─────────────┼──────────┼──────────┼────────┼──────────┤")
        total_pbrs = 0.0
        rows = []
        if weights.monotonicity != 0.0:
            rows.append(("monotonicity", moves[0]["monotonicity_before"],
                         moves[-1]["monotonicity_after"], weights.monotonicity))
        if weights.emptiness != 0.0:
            rows.append(("emptiness   ", moves[0].get("emptiness_before", 0.0),
                         moves[-1].get("emptiness_after", 0.0), weights.emptiness))
        for name, phi0, phiT, wt in rows:
            contrib = (gamma_T * phiT - phi0) * wt
            total_pbrs += contrib
            logger.print(
                f"    │ {name:<12}│ {phi0:>8.1f} │ {phiT:>8.1f} │ {wt:>6.2f} │ {contrib:>9.2f} │"
            )
        logger.print("    ├─────────────┼──────────┼──────────┼────────┼──────────┤")
        logger.print(f"    │ TOTAL       │          │          │        │ {total_pbrs:>9.2f} │")
        logger.print("    └─────────────┴──────────┴──────────┴────────┴──────────┘")


def print_last_steps(logger, episode: dict, num_steps: int) -> None:
    moves = episode.get("moves", [])
    if not moves:
        return
    show = moves[-num_steps:]
    start = len(moves) - len(show)
    pts = [str(m.get("points_earned", 0)) for m in show]
    logger.print(f"\n  Last {len(show)} steps (pts: {' → '.join(pts)}):")
    for i, m in enumerate(show):
        logger.print(
            f"\n  Step {start + i + 1}: {DIRECTION_NAMES[m['selected_direction']]} "
            f"(+{m.get('points_earned', 0)} pts)"
        )
        if "result_state" in m:
            logger.print(format_grid(m["result_state"], indent="  "))


def print_final_state(logger, episode: dict) -> None:
    if "final_state" in episode:
        logger.print("\n  Final state:")
        logger.print(format_grid(episode["final_state"], indent="  "))
