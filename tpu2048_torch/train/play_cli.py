"""Interactive terminal clients (counterpart of
``tpu2048/train/play_cli.py``): ``human_play`` and ``watch_agent``.

The board is a batch of one on the port's engine, on the chosen device:
``engine.all_moves`` of it (the merge kernel on a card) gives the legality,
each direction's points (0 where illegal) and the moved boards, and
``engine.step`` hands back the next board's moves, so each move launches the
merge once. Spawns come from a ``torch.Generator`` seeded by ``seed``, or
from injected draws (``engine.spawn_tile``'s), so a test can replay another
engine's game. The transcript has the JAX clients' lines and formats.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from .. import DIRECTION_NAMES, DOWN, LEFT, RIGHT, UP, resolve_device
from ..env import engine
from ..models.encoding import encode_boards
from ..utils.printing import format_grid

KEYMAP = {
    "w": UP, "s": DOWN, "a": LEFT, "d": RIGHT,
    "\x1b[A": UP, "\x1b[B": DOWN, "\x1b[C": RIGHT, "\x1b[D": LEFT,
}
HUMAN_HEADER = ("🎮 2048 - Human Player Mode",
                "Controls: W/↑=Up, S/↓=Down, A/←=Left, D/→=Right, Q=Quit",
                "-" * 40)


def _clear() -> None:
    os.system("clear" if os.name == "posix" else "cls")


def _display(grid: list) -> None:
    print()
    print(format_grid(grid, ""))
    print(f"Score: {sum(2 ** c for row in grid for c in row if c > 0)}")


def get_keypress() -> str:
    """One key from the terminal in raw mode (an arrow key's 3 bytes)."""
    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    try:
        tty.setraw(fd)
        ch = sys.stdin.read(1)
        if ch == "\x1b":
            ch += sys.stdin.read(2)
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
    return ch


class _Board:
    """One game on the port's engine: the board, its moves on the host, and
    the spawn source (a generator, or a (T, 2, 1) tensor of draws taken one
    a move)."""

    def __init__(self, device, seed: int, board=None, spawns=None):
        self.device = resolve_device(device)
        self.spawns, self.t = spawns, 0
        self.gen = (torch.Generator(device=self.device).manual_seed(seed)
                    if spawns is None or board is None else None)
        if board is None:
            self.board = engine.reset(1, self.device, generator=self.gen)
        else:
            self.board = torch.as_tensor(board, dtype=torch.int32,
                                         device=self.device).reshape(1, 4, 4)
        self._read(engine.all_moves(self.board))

    def _read(self, moves) -> None:
        self.moves = moves
        self.grid = self.board[0].tolist()
        self.legal = moves.legal[:, 0].tolist()
        self.preview = moves.scores[:, 0].tolist()

    def step(self, d: int) -> tuple:
        """(points, done) of the legal move ``d``; the board advances."""
        if self.spawns is not None:
            draws = self.spawns[self.t].to(self.device)
        else:
            draws = engine.spawn_draws((1,), self.gen, self.device)
        self.t += 1
        res = engine.step(self.board, torch.tensor([d], device=self.device), draws,
                          moves=self.moves)
        points = self.preview[d]
        self.board = res.board
        self._read(res.moves)
        return points, not any(self.legal)


def human_play(device="cuda", seed: int = 0, *, get_key=get_keypress,
               board=None, spawns=None) -> dict:
    """Play 2048 in the terminal with WASD or the arrow keys (Q quits).
    ``get_key`` is the key source, ``board`` (4, 4) and ``spawns`` replace
    the seeded start and spawns. Returns the moves, points and final board."""
    _clear()
    print("\n".join(HUMAN_HEADER))
    game = _Board(device, seed, board, spawns)
    moves = total = 0
    _display(game.grid)

    while any(game.legal):
        print("\nYour move: ", end="", flush=True)
        key = get_key()
        if key.lower() == "q":
            print("\n\n👋 Thanks for playing!")
            break
        d = KEYMAP.get(key.lower() if len(key) == 1 else key)
        if d is None:
            print("Invalid key. Use WASD or arrow keys.")
            continue
        if not game.legal[d]:
            print(f"Can't move {DIRECTION_NAMES[d].lower()}! Try another direction.")
            continue
        points, done = game.step(d)
        moves += 1
        total += points
        _clear()
        print("\n".join(HUMAN_HEADER))
        print(f"Move {moves}: {DIRECTION_NAMES[d]} (+{points} points)")
        _display(game.grid)
        if done:
            break

    grid = game.grid
    max_tile = max(2 ** c if c > 0 else 0 for row in grid for c in row)
    print("\n" + "=" * 40)
    print("🎮 GAME OVER!")
    print(f"Final Score: {sum(2 ** c for row in grid for c in row if c > 0)}")
    print(f"Total Moves: {moves}")
    print(f"Highest Tile: {max_tile}")
    if max_tile >= 2048:
        print("🎉 Congratulations! You reached 2048!")
    print("=" * 40)
    return dict(moves=moves, points=total, final_board=grid)


def watch_agent(model_path=None, delay: float = 0.5, seed: int = 0, search: int = 0,
                device="cuda", *, sleep=time.sleep, board=None, spawns=None) -> dict:
    """Watch an agent play one game, with each move's best available points
    beside it and an EMA of the step reward.

    Without ``model_path``, an untrained ``MLPConfig(hidden_dim=64)`` with
    live heads from a generator seeded by ``seed``. ``search`` > 0 picks the
    argmax of the expectimax scores at depth ``min(search, 2)`` with the
    checkpoint's coefs (``load_search_coefs``; ``SearchCoefs()`` without a
    model); otherwise actions are sampled from the masked policy with
    ``numpy.random.default_rng(seed)``. ``sleep`` waits ``delay`` between
    moves. Returns a summary: the moves, the points, the final board, and
    each move's board before it and action."""
    from ..algo.search import SearchCoefs, expectimax_scores
    from ..models.mlp import GameMLP, MLPConfig

    dev = resolve_device(device)
    if model_path:
        from .evaluate import load_model_checkpoint

        print(f"Loading model from: {model_path}")
        model, _, _ = load_model_checkpoint(model_path, dev)
    else:
        print("Playing with random agent (no model specified)")
        model = GameMLP(MLPConfig(hidden_dim=64), zero_heads=False,
                        generator=torch.Generator().manual_seed(seed)).to(dev).eval()

    depth = 0
    if search:
        coefs = SearchCoefs()
        if model_path:
            from .evaluate import load_search_coefs

            coefs = load_search_coefs(model_path)
        depth = max(1, min(int(search), 2))
        print(f"Expectimax move selection (depth={depth}, coefs={coefs})")
    rng = np.random.default_rng(seed)
    game = _Board(dev, seed, board, spawns)

    print("\nStarting game...")
    _display(game.grid)

    moves = total_points = 0
    total_reward, momentum, step = 0.0, 0.90, 1
    history = []
    while any(game.legal):
        previews = game.preview
        best_dir = int(np.argmax(previews))
        best_points = previews[best_dir]
        with torch.inference_mode():
            if depth:
                scores = expectimax_scores(model, game.board, game.moves, coefs, depth)
                action = int(np.argmax(scores[0].cpu().numpy()))
            else:
                logits, _ = model(encode_boards(game.board))
                logits = logits[0].cpu().numpy()
                masked = np.where(game.legal, logits, -np.inf)
                probs = np.exp(masked - masked.max())
                probs /= probs.sum()
                action = int(rng.choice(4, p=probs))
        history.append((game.grid, action))

        points, done = game.step(action)
        moves += 1
        total_points += points

        step_reward = ((1.0 if action == best_dir else points / best_points)
                       if best_points else 0)
        total_reward = total_reward * momentum + step_reward * (1 - momentum)
        corrected = total_reward / (1 - momentum ** step)

        print(f"\nMove {moves}: {DIRECTION_NAMES[action]} (points earned: {points})")
        print(f"Best available: {DIRECTION_NAMES[best_dir]} ({best_points} points)")
        print(f"Step reward: {step_reward:.3f} | Total reward (EMA): "
              f"{total_reward:.3f} | Bias Corrected: {corrected:.3f}")
        _display(game.grid)
        step += 1
        if done:
            print("\n🎮 Game Over!")
            break
        sleep(delay)

    score = sum(2 ** c for row in game.grid for c in row if c > 0)
    print(f"\n{'=' * 25}")
    print(f"Final Score: {score}")
    print(f"Total Moves: {moves}")
    print(f"Total Reward: {total_points}")
    print(f"{'=' * 25}\n")
    return dict(moves=moves, points=total_points, score=score,
                final_board=game.grid, history=history)
