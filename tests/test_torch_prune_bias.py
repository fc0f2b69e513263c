"""scripts/torch_prune_bias.py, the port's prune-bias check, against the JAX
package's search (``tpu2048.algo.search.expectimax_scores``, as
scripts/prune_bias.py calls it) on the committed checkpoints_expA (MLP
H=196x2, its calibrated search coefficients), on the CPU.

* Depth 2 on 8 boards and depth 3 on one board, from fixed numpy seeds: the
  port's exact (prune 0) and pruned (k = 2, 3) root scores equal the JAX
  package's to rtol 1e-5 and atol 1e-4 (float32 sums over the 32 spawn
  slots of every chance node, taken in another order; measured up to
  4e-7 relative), -inf at the same entries; the changed moves, counted as
  the JAX script counts them (first argmax over the legal moves), equal.
  The depth-3 board (the first of ``default_rng(2)``) is one whose move
  top-k pruning changes at k = 2 and 3 in the JAX package.
* Chunked boards score as one chunk; the chunk follows the cap.
* Boards come from the checkpoint's greedy games, the same for the same
  seeds; the whole check through ``main``; ``cuda`` without a card raises.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scripts import torch_prune_bias as TPB
from tests.conftest import random_board_np
from tests.test_torch_engine import one_torch_thread  # noqa: F401  (autouse)
from tpu2048.algo import search as JS
from tpu2048.env import engine as jengine
from tpu2048.models import mlp as jmlp
from tpu2048.train.evaluate import load_model_checkpoint as jload
from tpu2048.train.evaluate import load_search_coefs as jcoefs
from tpu2048_torch.env import engine
from tpu2048_torch.train.evaluate import load_model_checkpoint

EXPA = Path(__file__).resolve().parent.parent / "checkpoints_expA"
RTOL, ATOL = 1e-5, 1e-4
KS = TPB.PRUNE_KS  # (2, 3), the JAX script's


def seeded_boards(seeds, max_exp: int = 11) -> np.ndarray:
    """The first board of ``default_rng(seed)`` for each seed."""
    return np.stack([random_board_np(np.random.default_rng(s), max_exp=max_exp)
                     for s in seeds])


def jax_scores(boards: np.ndarray, depth: int, prune_k: int) -> np.ndarray:
    params, cfg, _ = jload(EXPA)
    coefs = jcoefs(EXPA)
    fn = jax.jit(lambda p, b: JS.expectimax_scores(
        lambda q, x: jmlp.apply(q, cfg, x), p, b, None, coefs, depth, prune_k))
    return np.asarray(fn(params, jnp.asarray(boards)))


def jax_changed(exact: np.ndarray, pruned: np.ndarray, legal: np.ndarray) -> int:
    """The changed moves as scripts/prune_bias.py counts them."""
    ex = np.where(legal, exact, -np.inf)
    pr = np.where(legal, pruned, -np.inf)
    return int((ex.argmax(-1) != pr.argmax(-1)).sum())


CASES = {2: seeded_boards(range(8)), 3: seeded_boards([2])}


@pytest.fixture(scope="module", params=sorted(CASES), ids=lambda d: f"depth{d}")
def case(request):
    depth = request.param
    boards = CASES[depth]
    port = TPB.prune_bias(EXPA, depth=depth, device="cpu", boards=boards, say=lambda s: None)
    want = {k: jax_scores(boards, depth, k) for k in (0, *KS)}
    return depth, port, want


def _assert_scores(got: np.ndarray, want: np.ndarray) -> None:
    np.testing.assert_array_equal(got == -np.inf, want == -np.inf)
    fin = np.isfinite(want)
    assert np.isfinite(got[fin]).all()
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


def test_root_scores_match_jax(case):
    depth, port, want = case
    _assert_scores(port["exact"], want[0])
    for k in KS:
        _assert_scores(port["pruned"][k], want[k])
    assert port["exact"].dtype == np.float32 and port["exact"].shape == (len(CASES[depth]), 4)


def test_changed_moves_match_jax(case):
    depth, port, want = case
    legal = np.asarray(jengine.all_moves(jnp.asarray(CASES[depth])).legal).T
    np.testing.assert_array_equal(port["legal"], legal)
    for k in KS:
        expected = jax_changed(want[0], want[k], legal)
        assert port["stats"][k]["changed"] == expected
        assert port["stats"][k]["agreement"] == 1.0 - expected / len(legal)
        if depth == 3:  # the board whose move pruning changes
            assert expected == 1 and port["stats"][k]["shift_max"] > 0
        else:  # no inner max node below depth 3: pruning changes nothing
            assert expected == 0 and port["stats"][k]["shift_max"] == 0.0
            np.testing.assert_array_equal(port["pruned"][k], port["exact"])


def test_score_shift_statistics(case):
    depth, port, _ = case
    legal = port["legal"]
    for k in KS:
        dev = np.abs(port["exact"][legal] - port["pruned"][k][legal]).astype(np.float64)
        s = port["stats"][k]
        assert s["shift_mean"] == pytest.approx(dev.mean())
        assert s["shift_mean_sigma"] == pytest.approx(dev.mean() / port["sigma"])
        assert s["shift_p95"] == pytest.approx(np.percentile(dev, 95))
        assert s["shift_max"] == pytest.approx(dev.max())


def test_chunks_score_as_one():
    model, mcfg, _ = load_model_checkpoint(EXPA, device="cpu")
    coefs = TPB.load_search_coefs(EXPA)
    boards = CASES[2]
    one = TPB.root_scores(model, boards, coefs, 2, 0, chunk=len(boards))
    for chunk in (1, 3):
        _assert_scores(TPB.root_scores(model, boards, coefs, 2, 0, chunk), one)
    per_board = TPB.leaves_in_flight(3) * TPB.leaf_bytes(mcfg.hidden_dim)
    assert TPB.leaves_in_flight(3) == 2048 and TPB.leaves_in_flight(2) == 512
    assert TPB.chunk_boards(3, mcfg.hidden_dim, 5 * per_board + 1) == 5
    assert TPB.chunk_boards(3, mcfg.hidden_dim, per_board - 1) == 1


def test_greedy_boards_are_reached_states():
    model, _, _ = load_model_checkpoint(EXPA, device="cpu")
    a = TPB.greedy_boards(model, 16, games=4, max_steps=32)
    b = TPB.greedy_boards(model, 16, games=4, max_steps=32)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (16, 4, 4) and a.dtype == np.int32
    assert engine.all_moves(torch.as_tensor(a)).any_legal.all()  # alive when recorded
    assert len(np.unique(a.reshape(16, -1), axis=0)) == 16
    assert TPB.greedy_boards(model, 1000, games=2, max_steps=8).shape == (16, 4, 4)


def test_main_prints_the_jax_scripts_lines(capsys):
    out = TPB.main([str(EXPA), "4", "1", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "boards sampled: 4 (from greedy games" in text and "depth=1" in text
    assert "peak memory cap 4096 MiB: chunks of" in text and "peak not measured (cpu)" in text
    for k in KS:
        assert f"prune_k={k}: changed moves 0/4, argmax agreement 100.00%" in text
    assert out["chunk"] == TPB.chunk_boards(1, 196, 4096 << 20) and out["peak_bytes"] is None


def test_cuda_without_a_card_raises():
    with pytest.raises(RuntimeError, match="cuda"):
        TPB.main([str(EXPA), "4", "1"])
