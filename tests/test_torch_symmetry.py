"""The port's symmetry transforms (tpu2048_torch/env/symmetry.py) against
tpu2048.env.symmetry: integer outputs, bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import random_board_np
from tests.test_torch_engine import one_torch_thread  # noqa: F401  (autouse)
from tpu2048.env import symmetry as jsym
from tpu2048_torch.env import symmetry as tsym


def test_tables_equal_the_reference():
    np.testing.assert_array_equal(tsym.ACTION_MAP, jsym.ACTION_MAP)
    np.testing.assert_array_equal(tsym.PERM, jsym.PERM)
    np.testing.assert_array_equal(tsym.CELL_PERM, jsym.CELL_PERM)
    assert (tsym.IDENTITY, tsym.MIRROR_H, tsym.MIRROR_V, tsym.ROT90, tsym.ROT180,
            tsym.ROT270) == (jsym.IDENTITY, jsym.MIRROR_H, jsym.MIRROR_V,
                             jsym.ROT90, jsym.ROT180, jsym.ROT270)


@pytest.mark.parametrize("transform", range(6))
def test_transforms_bit_exact(transform):
    """Each transform id on 64 seeded boards, actions, masks and logprobs,
    with a per-row transform vector mixing it with the others."""
    rng = np.random.default_rng(transform)
    boards = np.stack([random_board_np(rng) for _ in range(64)])
    tf = rng.integers(0, 6, 64)
    tf[::2] = transform
    actions = rng.integers(0, 4, 64)
    mask = rng.random((64, 4)) < 0.4
    logprobs = rng.normal(size=(64, 4)).astype(np.float32)

    got_b = tsym.transform_board(torch.as_tensor(boards), torch.as_tensor(tf))
    np.testing.assert_array_equal(
        got_b.numpy(), np.asarray(jsym.transform_board(jnp.asarray(boards), jnp.asarray(tf))))
    assert got_b.dtype == torch.int32
    np.testing.assert_array_equal(
        tsym.transform_action(torch.as_tensor(actions), torch.as_tensor(tf)).numpy(),
        np.asarray(jsym.transform_action(jnp.asarray(actions), jnp.asarray(tf))))
    for vec in (mask, logprobs):
        got = tsym.transform_action_vector(torch.as_tensor(vec), torch.as_tensor(tf))
        assert got.dtype == torch.as_tensor(vec).dtype
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jsym.transform_action_vector(jnp.asarray(vec),
                                                                 jnp.asarray(tf))))


def test_int8_boards_keep_their_dtype():
    """The learner transforms the rollout's int8 boards."""
    rng = np.random.default_rng(9)
    boards = np.stack([random_board_np(rng) for _ in range(16)]).astype(np.int8)
    tf = rng.integers(0, 6, 16)
    got = tsym.transform_board(torch.as_tensor(boards), torch.as_tensor(tf))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jsym.transform_board(jnp.asarray(boards), jnp.asarray(tf))))
