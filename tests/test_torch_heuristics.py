"""The port's heuristics (tpu2048_torch/env/heuristics.py) against the JAX
ones: integer functions, bit-exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import random_board_np
from tests.test_torch_engine import one_torch_thread  # noqa: F401  (autouse)
from tpu2048.env import heuristics as JH
from tpu2048_torch.env import heuristics as TH


def _random_boards(seed, n=512, **kw):
    rng = np.random.default_rng(seed)
    return np.stack([random_board_np(rng, **kw) for _ in range(n)])


def _tied_max_boards(seed, n=512):
    """Boards with two to four cells at the max exponent, placed anywhere:
    the first max in row-major order decides the corner test, wherever the
    others are."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 6, size=(n, 16))
    for i in range(n):
        cells = rng.choice(16, size=rng.integers(2, 5), replace=False)
        b[i, cells] = 7
    return b.reshape(n, 4, 4).astype(np.int32)


def _edge_boards():
    empty = np.zeros((4, 4), np.int32)
    full_same = np.full((4, 4), 3, np.int32)
    corner_and_centre = np.zeros((4, 4), np.int32)
    corner_and_centre[1, 1] = corner_and_centre[3, 3] = 9  # first max off-corner
    centre_then_corner = np.zeros((4, 4), np.int32)
    centre_then_corner[0, 3] = centre_then_corner[2, 1] = 9  # first max in a corner
    return np.stack([empty, full_same, corner_and_centre, centre_then_corner])


BOARD_SETS = {
    "random": lambda: _random_boards(0),
    "sparse": lambda: _random_boards(1, max_exp=4, p_zero=0.8),
    "tied_max": lambda: _tied_max_boards(2),
    "edge": _edge_boards,
}


@pytest.mark.parametrize("fn", ["monotonicity", "emptiness"])
@pytest.mark.parametrize("boards", sorted(BOARD_SETS))
def test_heuristic_is_bit_exact(fn, boards):
    b = BOARD_SETS[boards]()
    want = np.asarray(jax.jit(getattr(JH, fn))(jnp.asarray(b)))
    got = getattr(TH, fn)(torch.as_tensor(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_monotonicity_batch_shapes():
    """Leading batch axes of any rank, as the reference takes them."""
    b = _tied_max_boards(3, n=24).reshape(2, 3, 4, 4, 4)
    want = np.asarray(JH.monotonicity(jnp.asarray(b)))
    got = TH.monotonicity(torch.as_tensor(b)).numpy()
    assert got.shape == (2, 3, 4)
    np.testing.assert_array_equal(got, want)


# The rest of the suite: bit-exact. Every function but topological_score is
# a sum of integers or of multiples of 0.25 in float32; topological_score
# sums multiples of 0.1, and the port takes its position terms in the order
# of the JAX package's reduction on the CPU (row-major, one by one).
EXACT_SUITE = ("smoothness", "corner_bonus", "adjacency_bonus", "monotonic_chain_score",
               "choose_anchor_corner", "topological_score")
SUITE_SETS = dict(BOARD_SETS, high=lambda: _random_boards(4, max_exp=17, p_zero=0.1),
                  empty=lambda: np.zeros((3, 4, 4), np.int32))


@pytest.mark.parametrize("fn", EXACT_SUITE)
@pytest.mark.parametrize("boards", sorted(SUITE_SETS))
def test_suite_function_is_bit_exact(fn, boards):
    b = SUITE_SETS[boards]()
    want = np.asarray(jax.jit(getattr(JH, fn))(jnp.asarray(b)))
    got = getattr(TH, fn)(torch.as_tensor(b)).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("boards", sorted(SUITE_SETS))
def test_topological_score_with_anchor_is_bit_exact(boards):
    b = SUITE_SETS[boards]()
    anchor = np.random.default_rng(5).integers(0, 4, len(b)).astype(np.int32)
    want = np.asarray(jax.jit(JH.topological_score)(jnp.asarray(b), jnp.asarray(anchor)))
    got = TH.topological_score(torch.as_tensor(b), torch.as_tensor(anchor)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_full_suite_and_live_potentials_match():
    b = np.concatenate([_random_boards(6, n=256), _edge_boards()])
    want = jax.jit(JH.full_suite)(jnp.asarray(b))
    got = TH.full_suite(torch.as_tensor(b))
    assert list(got) == list(JH.full_suite(jnp.asarray(b[:1])))  # the reference's order
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(w), err_msg=k)
    for g, w in zip(TH.live_potentials(torch.as_tensor(b)), JH.live_potentials(jnp.asarray(b))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_snake_tables_are_the_references():
    from tpu2048.env import heuristics as jh

    np.testing.assert_array_equal(np.array(TH._SNAKE_ORDER), jh._SNAKE_ORDER)
    np.testing.assert_array_equal(np.array(TH._SNAKE_INDEX), jh._SNAKE_INDEX)
