"""The port's engine (tpu2048_torch/env/engine.py) against the JAX engine:
transitions replayed exactly, spawns held distributionally."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from tests.conftest import random_board_np
from tpu2048.env import engine as jengine
from tpu2048_torch.env import engine as tengine

J_STEP = jax.jit(jengine.step)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one CPU thread for a module's tests. The suite runs in
    several worker processes side by side, and torch's thread pool in each
    of them then spins against the others: small eager operations slow
    down by orders of magnitude. Port test modules import this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
J_MOVES = jax.jit(jengine.all_moves)


def replay_draws(moved: np.ndarray, after: np.ndarray) -> np.ndarray:
    """(2, N) spawn draws under which ``tengine.spawn_tile`` turns the
    pre-spawn boards ``moved`` (N, 4, 4) into ``after``. Boards with no
    spawn get 0.5, 0.5 (unused: the port spawns only after a legal move)."""
    b = moved.reshape(len(moved), 16)
    a = after.reshape(len(after), 16)
    draws = np.full((2, len(b)), 0.5, np.float32)
    for i in range(len(b)):
        diff = np.nonzero(b[i] != a[i])[0]
        if len(diff) == 0:
            continue
        assert len(diff) == 1 and b[i, diff[0]] == 0, (b[i], a[i])
        empty = list(np.nonzero(b[i] == 0)[0])
        draws[0, i] = (empty.index(diff[0]) + 0.5) / len(empty)
        draws[1, i] = 0.0 if a[i, diff[0]] == 1 else 0.95
    return draws


def _boards(seed, n, **kw):
    rng = np.random.default_rng(seed)
    return np.stack([random_board_np(rng, **kw) for _ in range(n)])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_step_replays_jax_step(seed):
    """Every field of the JAX step's result, with its spawns injected. The
    actions include illegal ones (no move, no spawn)."""
    boards = np.concatenate([_boards(seed, 240, max_exp=6, p_zero=0.3),
                             _boards(seed + 50, 16, max_exp=3, p_zero=0.85)])
    boards[-1] = (np.indices((4, 4)).sum(0) % 2 + 1)  # no move left at all
    actions = np.random.default_rng(seed + 100).integers(0, 4, 256)
    want = J_STEP(jnp.asarray(boards), jnp.asarray(actions, jnp.int32),
                  jax.random.key(seed))
    moved = np.asarray(J_MOVES(jnp.asarray(boards)).boards)[actions,
                                                              np.arange(256)]
    draws = replay_draws(moved, np.asarray(want.board))
    got = tengine.step(torch.as_tensor(boards), torch.as_tensor(actions),
                       torch.as_tensor(draws))
    for f in ("board", "reward", "done", "invalid", "max_created"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    for f in ("boards", "scores", "max_created", "legal"):
        np.testing.assert_array_equal(getattr(got.moves, f).numpy(),
                                      np.asarray(getattr(want.moves, f)))
    assert np.asarray(want.invalid).any() and not np.asarray(want.invalid).all()


def test_spawn_distribution():
    """Uniform over the empty cells, 90% exponent 1 (chi-squared, fixed
    seed, so the outcome is fixed; a 0.001 level keeps a right spawn rule
    far from the edge)."""
    board = np.array([[1, 0, 2, 0], [0, 3, 3, 1], [2, 0, 1, 2], [0, 4, 5, 6]],
                     np.int32)
    n = 40_000
    boards = torch.as_tensor(np.broadcast_to(board, (n, 4, 4)).copy())
    gen = torch.Generator().manual_seed(1234)
    out = tengine.spawn_tile(boards, tengine.spawn_draws((n,), gen, "cpu"))
    diff = (out != boards).reshape(n, 16)
    assert (diff.sum(1) == 1).all()
    empty = np.nonzero(board.reshape(16) == 0)[0]
    cells = diff.long().argmax(1).numpy()
    counts = np.bincount(cells, minlength=16)
    assert counts.sum() == counts[empty].sum() == n
    assert stats.chisquare(counts[empty]).pvalue > 1e-3
    exps = out.reshape(n, 16)[torch.arange(n), torch.as_tensor(cells)].numpy()
    assert set(np.unique(exps)) == {1, 2}
    assert stats.binomtest(int((exps == 1).sum()), n, 0.9).pvalue > 1e-3


def test_spawn_leaves_full_board_unchanged():
    full = torch.as_tensor(_boards(3, 8, p_zero=0.0)).clamp(min=1)
    draws = torch.rand((2, 8), generator=torch.Generator().manual_seed(0))
    assert torch.equal(tengine.spawn_tile(full, draws), full)


def test_reset_places_two_tiles():
    gen = torch.Generator().manual_seed(0)
    boards = tengine.reset(512, "cpu", generator=gen)
    assert boards.shape == (512, 4, 4) and boards.dtype == torch.int32
    assert ((boards != 0).reshape(512, 16).sum(1) == 2).all()
    assert set(boards.unique().tolist()) <= {0, 1, 2}


def test_reset_needs_a_source_of_randomness():
    with pytest.raises(ValueError):
        tengine.reset(4, "cpu")


def test_board_scores_and_max_tile_match_jax():
    boards = _boards(4, 128)
    boards[0] = 0
    for jf, tf in ((jengine.board_scores, tengine.board_scores),
                   (jengine.max_tile_value, tengine.max_tile_value)):
        np.testing.assert_array_equal(tf(torch.as_tensor(boards)).numpy(),
                                      np.asarray(jax.jit(jf)(jnp.asarray(boards))))
