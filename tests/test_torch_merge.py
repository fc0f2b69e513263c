"""The port's four-direction merge (tpu2048_torch/ops/merge.py) against the
JAX engine and the Pallas kernel. Integer work: every comparison is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import random_board_np
from tests.test_torch_engine import one_torch_thread  # noqa: F401  (autouse)
from tpu2048.env import engine as jengine
from tpu2048_torch.env import engine as tengine
from tpu2048_torch.ops import merge

FIELDS = ("boards", "scores", "max_created", "legal")


def edge_boards() -> np.ndarray:
    empty = np.zeros((4, 4), np.int32)
    no_move = (np.indices((4, 4)).sum(0) % 2 + 1).astype(np.int32)
    all_same = np.full((4, 4), 3, np.int32)
    one_big = np.zeros((4, 4), np.int32)
    one_big[1, 2] = 15
    return np.stack([empty, no_move, all_same, one_big])


def high_boards() -> np.ndarray:
    """Exponents 14..32, a third of the cells empty: created tiles past 2^31
    wrap the int32 score, and from 2^32 on add 0. The first board has a row
    of two 31s, the second two 32s."""
    rng = np.random.default_rng(3)
    b = rng.integers(14, 33, size=(2000, 4, 4))
    b = np.where(rng.random((2000, 4, 4)) < 0.35, 0, b).astype(np.int32)
    b[:2] = 0
    b[0, 0, :2] = 31
    b[1, 2, 2:] = 32
    return b


@pytest.fixture(scope="module")
def boards():
    rng = np.random.default_rng(0)
    rand = np.stack([random_board_np(rng) for _ in range(512)])
    return np.concatenate([rand, edge_boards()])


def _assert_moves_equal(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("board_set", ["game", "exponents_14_32"])
def test_plain_all_moves_matches_jax_engine(board_set, boards):
    """The plain version, which the card check holds the kernel against,
    equals the JAX engine on game boards and on exponents past 15."""
    if board_set == "exponents_14_32":
        boards = high_boards()
    want = jax.jit(jengine.all_moves)(jnp.asarray(boards))
    got = tengine.all_moves(torch.as_tensor(boards))
    assert got.legal.dtype == torch.bool and got.scores.dtype == torch.int32
    _assert_moves_equal(
        tengine.MoveSet(*(t.numpy() for t in got)), want)


def test_plain_all_moves_matches_pallas_kernel(boards):
    from jax.experimental.pallas import tpu as pltpu
    from tpu2048.ops import pallas_merge

    with pltpu.force_tpu_interpret_mode():
        want = pallas_merge.all_moves(jnp.asarray(boards), block_n=128)
    got = merge.merge4_plain(torch.as_tensor(boards))
    _assert_moves_equal(tengine.MoveSet(*(t.numpy() for t in got)), want)


def test_merge_lines_left_matches_jax():
    rng = np.random.default_rng(1)
    lines = rng.integers(0, 6, size=(2000, 4)).astype(np.int32)
    want = jax.jit(jengine.merge_lines_left)(jnp.asarray(lines))
    got = tengine.merge_lines_left(torch.as_tensor(lines))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_all_moves_keeps_batch_shape():
    rng = np.random.default_rng(2)
    b = np.stack([random_board_np(rng) for _ in range(6)]).reshape(2, 3, 4, 4)
    got = tengine.all_moves(torch.as_tensor(b))
    want = jax.jit(jengine.all_moves)(jnp.asarray(b))
    assert tuple(got.boards.shape) == (4, 2, 3, 4, 4)
    assert tuple(got.action_mask.shape) == (2, 3, 4)
    _assert_moves_equal(tengine.MoveSet(*(t.numpy() for t in got)), want)
    np.testing.assert_array_equal(got.action_mask.numpy(),
                                  np.asarray(want.action_mask))
    np.testing.assert_array_equal(got.preview_rewards.numpy(),
                                  np.asarray(want.preview_rewards))
    np.testing.assert_array_equal(got.any_legal.numpy(),
                                  np.asarray(want.any_legal))


def test_kernel_launcher_refuses_cpu_tensor():
    """The CUDA wrapper never falls back to the plain version."""
    before = merge.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        merge.merge4_cuda(torch.zeros((3, 4, 4), dtype=torch.int32))
    assert merge.launches == before


@pytest.mark.parametrize("bad, err", [
    (torch.zeros((3, 4, 4), dtype=torch.int64), TypeError),
    (torch.zeros((3, 16), dtype=torch.int32), ValueError),
    (torch.zeros((4, 4, 3), dtype=torch.int32).transpose(1, 2), ValueError),
])
def test_plain_version_checks_its_input(bad, err):
    with pytest.raises(err):
        merge.merge4_plain(bad)


def test_cpu_all_moves_does_not_count_launches(boards):
    merge.launches = 0
    tengine.all_moves(torch.as_tensor(boards))
    assert merge.launches == 0


@pytest.mark.parametrize("n", [1, 7, 256])
def test_output_buffer_layout(n):
    """The four fields are views of one buffer, each with the contract's
    shape and dtype, at a 16-byte-aligned address, none overlapping."""
    fields = merge.alloc_outputs(n, "cpu")
    shapes = [(4, n, 4, 4), (4, n), (4, n), (4, n)]
    dtypes = [torch.int32, torch.int32, torch.int32, torch.bool]
    spans = []
    for f, t, shape, dtype in zip(FIELDS, fields, shapes, dtypes):
        assert tuple(t.shape) == shape and t.dtype == dtype, f
        assert t.is_contiguous(), f
        assert t.data_ptr() % 16 == 0, f
        assert t.untyped_storage().data_ptr() == fields[0].untyped_storage().data_ptr(), f
        spans.append((t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()))
    spans.sort()
    for (_, end), (start, _) in zip(spans, spans[1:]):
        assert end <= start
    assert spans[-1][1] <= fields[0].data_ptr() + fields[0].untyped_storage().nbytes()


@pytest.mark.gpu
def test_kernel_matches_plain_on_card(boards):
    """Bit-exact on the card, through the kernel's own choice of design and
    each design forced. Decides inside the body whether a card is present,
    so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card via chip_smoke.py)")
    b = torch.as_tensor(np.concatenate([boards, high_boards()]), device="cuda")
    want = merge.merge4_plain(b)
    for path in merge.PATHS:
        before = merge.launches
        got = merge.merge4_cuda(b, path=path)
        torch.cuda.synchronize()
        assert merge.launches == before + 1
        for f, g, w in zip(FIELDS, got, want):
            assert torch.equal(g, w), (path, f)


@pytest.mark.gpu
def test_captured_launch_replays_on_card():
    """A merge4_cuda call captured in a CUDA graph replays on new boards
    copied into its input, bit-exact; an empty capture would leave the -1s."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card via chip_smoke.py)")
    rng = np.random.default_rng(4)
    static = torch.as_tensor(np.stack([random_board_np(rng) for _ in range(256)]),
                             device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        merge.merge4_cuda(static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = merge.merge4_cuda(static)
    for t in captured:
        t.fill_(True if t.dtype == torch.bool else -1)
    new = np.stack([random_board_np(rng) for _ in range(256)])
    static.copy_(torch.as_tensor(new, device="cuda"))
    graph.replay()
    torch.cuda.synchronize()
    for f, g, w in zip(FIELDS, captured, merge.merge4_plain(static)):
        assert torch.equal(g, w), f
