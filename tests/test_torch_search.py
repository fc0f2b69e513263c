"""The port's expectimax search (tpu2048_torch/algo/search.py), its game loop
and its evaluation against the JAX package's, on the same boards and
weights."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import random_board_np
from tests.test_torch_engine import one_torch_thread, replay_draws  # noqa: F401
from tpu2048.algo import search as JS
from tpu2048.env import engine as jengine
from tpu2048.models import MLPConfig as JMLPConfig
from tpu2048.models import mlp as jmlp
from tpu2048.train.evaluate import load_model_checkpoint as jload
from tpu2048.train.evaluate import load_search_coefs as jcoefs
from tpu2048_torch.algo import search as TS
from tpu2048_torch.algo.rollout import play
from tpu2048_torch.models.mlp import GameMLP, MLPConfig
from tpu2048_torch.train import cli
from tpu2048_torch.train.checkpoint import params_to_state_dict
from tpu2048_torch.train.evaluate import BF16Leaves, run_search_eval
from tpu2048_torch.train.evaluate import load_model_checkpoint as tload
from tpu2048_torch.train.evaluate import load_search_coefs as tcoefs

ROOT = Path(__file__).resolve().parent.parent
# Nontrivial coefficients so every term of the backup is exercised (the JAX
# package's tests use the same).
COEFS = dict(points=0.1, mono=0.7, empt=0.3, sigma=2.5, mu=-0.4, gamma=0.97)
# Scores are float32 sums over the 32 spawn slots (and, deeper, over
# recursive backups) taken in another order in the two frameworks.
TOL = 1e-4


def _port_mlp(params, cfg):
    model = GameMLP(MLPConfig(**cfg.to_dict()))
    model.load_state_dict(params_to_state_dict(jax.tree.map(np.asarray, params)))
    return model.eval()


@pytest.fixture(scope="module")
def small():
    """(JAX params, JAX apply, port model): an H=32x1 MLP with live heads."""
    cfg = JMLPConfig(hidden_dim=32, num_layers=1)
    params = jmlp.init(jax.random.key(5), cfg, zero_heads=False)
    return params, (lambda p, x: jmlp.apply(p, cfg, x)), _port_mlp(params, cfg)


@pytest.fixture(scope="module")
def exp_a():
    """(JAX params, JAX apply, port model, coefs) of checkpoints_expA at its
    full width (H=196x2), with its calibrated search coefficients."""
    params, cfg, _ = jload(ROOT / "checkpoints_expA")
    model, _, _ = tload(ROOT / "checkpoints_expA", device="cpu")
    return (params, (lambda p, x: jmlp.apply(p, cfg, x)), model,
            tcoefs(ROOT / "checkpoints_expA"))


def _boards(seed, n):
    rng = np.random.default_rng(seed)
    b = np.stack([random_board_np(rng, max_exp=7) for _ in range(n)])
    b[-1] = np.indices((4, 4)).sum(0) % 2 + 1  # no legal move
    return b


def _jax_scores(apply_fn, params, boards, coefs, depth, prune_k):
    fn = jax.jit(lambda p, b: JS.expectimax_scores(
        apply_fn, p, b, None, JS.SearchCoefs(**coefs._asdict()), depth, prune_k))
    return np.asarray(fn(params, jnp.asarray(boards)))


def _port_scores(model, boards, coefs, depth, prune_k):
    with torch.inference_mode():
        return TS.expectimax_scores(model, torch.as_tensor(boards), None,
                                    coefs, depth, prune_k).numpy()


def _assert_scores_equal(got, want):
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(got == -np.inf, want == -np.inf)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("depth,prune_k,n", [(1, 0, 8), (2, 0, 3), (3, 2, 1)])
def test_expectimax_scores_match_jax(small, depth, prune_k, n):
    params, apply_fn, model = small
    coefs = TS.SearchCoefs(**COEFS)
    boards = _boards(depth, n + 1)
    got = _port_scores(model, boards, coefs, depth, prune_k)
    assert got.shape == (n + 1, 4) and got.dtype == np.float32
    assert (got[-1] == -np.inf).all()
    _assert_scores_equal(got, _jax_scores(apply_fn, params, boards, coefs,
                                          depth, prune_k))


@pytest.mark.parametrize("prune_k", [0, 2])
def test_state_values_match_jax(small, prune_k):
    params, apply_fn, model = small
    boards = _boards(7, 4)
    jc = JS.SearchCoefs(**COEFS)
    want_v, want_alive = jax.jit(lambda p, b: JS.state_values(
        apply_fn, p, b, jc, 2, prune_k))(params, jnp.asarray(boards))
    with torch.inference_mode():
        got_v, got_alive = TS.state_values(model, torch.as_tensor(boards),
                                           TS.SearchCoefs(**COEFS), 2, prune_k)
    np.testing.assert_array_equal(got_alive.numpy(), np.asarray(want_alive))
    assert not got_alive[-1] and got_v[-1] == 0.0
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=TOL, atol=TOL)


def test_top_k_first_orders_ties_as_jax():
    """Among equal values the lower index comes first, -inf included."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 3, size=(256, 4)).astype(np.float32)
    x[rng.random((256, 4)) < 0.2] = -np.inf
    for k in (1, 2, 3):
        _, want = jax.lax.top_k(jnp.asarray(x), k)
        got = TS.top_k_first(torch.as_tensor(x), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# All four moves legal and worth 0 points: with a zero critic and only the
# points term, the four 1-ply scores tie at exactly 0.
TIE_BOARD = np.array([[1, 2, 0, 0],
                      [0, 0, 0, 0],
                      [0, 0, 3, 0],
                      [0, 0, 0, 1]], np.int32)


def test_pruning_picks_tied_actions_as_top_k():
    """Depth-2 pruning to 2 actions on a board whose 1-ply scores all tie:
    the pruned value is the deep value of the two lowest-index actions (UP,
    DOWN), as ``jax.lax.top_k`` picks them, and another pick would give
    another value."""
    cfg = JMLPConfig(hidden_dim=16, num_layers=1)
    params = jmlp.init(jax.random.key(1), cfg, zero_heads=True)
    apply_fn = lambda p, x: jmlp.apply(p, cfg, x)  # noqa: E731
    model = _port_mlp(params, cfg)
    coefs = TS.SearchCoefs(points=0.1)
    board = TIE_BOARD[None]
    shallow = _port_scores(model, board, coefs, 1, 0)[0]
    assert (shallow == 0.0).all()
    deep = _port_scores(model, board, coefs, 2, 0)[0]
    assert max(deep[:2]) != max(deep[2:]) and max(deep[:2]) != deep.max()
    want_v, _ = jax.jit(lambda p, b: JS.state_values(
        apply_fn, p, b, JS.SearchCoefs(points=0.1), 2, 2))(params, jnp.asarray(board))
    with torch.inference_mode():
        got_v, _ = TS.state_values(model, torch.as_tensor(board), coefs, 2, 2)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_v.numpy()[0], max(deep[:2]), rtol=TOL, atol=TOL)


def test_depth1_full_width_expA(exp_a):
    params, apply_fn, model, coefs = exp_a
    assert coefs.sigma != 1.0 and coefs.mono > 0.0  # calibrated, not pure EV
    boards = _boards(11, 8)
    _assert_scores_equal(_port_scores(model, boards, coefs, 1, 0),
                         _jax_scores(apply_fn, params, boards, coefs, 1, 0))


def test_bf16_leaves_match_jax_bf16(exp_a):
    """The JAX package's bf16 leaves (``run_search_eval(bf16=True)``: input
    cast to bf16, floating params cast to bf16, and ``mlp.apply`` back in
    f32) against the port's ``BF16Leaves``; both differ from f32."""
    params, apply_fn, model, coefs = exp_a
    bf16_apply = lambda p, x: apply_fn(p, x.astype(jnp.bfloat16))  # noqa: E731
    bf16_params = jax.tree.map(
        lambda a: (a.astype(jnp.bfloat16)
                   if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a),
        params)
    boards = _boards(13, 8)
    want = _jax_scores(bf16_apply, bf16_params, boards, coefs, 1, 0)
    got = _port_scores(BF16Leaves(model), boards, coefs, 1, 0)
    _assert_scores_equal(got, want)
    f32 = _port_scores(model, boards, coefs, 1, 0)
    fin = np.isfinite(f32)
    assert np.abs(got[fin] - f32[fin]).max() > 10 * TOL * np.abs(f32[fin]).max()


def _jax_search_drive(apply_fn, params, n, max_steps, env_key, coefs, depth,
                      prune_k):
    """``search_rollout`` one move at a time, with its key splitting, keeping
    each move's boards, action and spawn."""
    jc = JS.SearchCoefs(**coefs._asdict())

    @jax.jit
    def one_move(boards, k_spawn):
        moves = jengine.all_moves(boards)
        action = jnp.argmax(JS.expectimax_scores(apply_fn, params, boards, moves,
                                                 jc, depth, prune_k), -1)
        res = jengine.step(boards, action, k_spawn, moves=moves)
        return moves, action, res

    k_reset, key = jax.random.split(env_key)
    boards = np.array(jengine.reset(k_reset, (n,)))
    out = dict(boards0=boards, actions=[], alive=[], moved=[], after=[])
    alive = np.ones(n, bool)
    points = np.zeros(n, np.int32)
    num_moves = np.zeros(n, np.int32)
    for _ in range(max_steps):
        if not alive.any():
            break
        key, k_spawn = jax.random.split(key)
        moves, action, res = one_move(jnp.asarray(boards), k_spawn)
        action = np.asarray(action)
        live = alive & np.asarray(moves.any_legal)
        points = points + np.where(live, np.asarray(res.reward), 0)
        after = np.asarray(res.board)
        out["actions"].append(action)
        out["alive"].append(live)
        out["moved"].append(np.asarray(moves.boards)[action, np.arange(n)])
        out["after"].append(after)
        boards = np.where(live[:, None, None], after, boards)
        num_moves = num_moves + live
        alive = live & ~np.asarray(res.done)
    out.update(points=points, final=boards, num_moves=num_moves)
    return out


def test_search_loop_replays_jax_search_rollout(exp_a):
    """``play(search=...)`` replays the JAX search rollout of
    checkpoints_expA at depth 1 move for move, with its spawns injected."""
    params, apply_fn, model, coefs = exp_a
    n, steps, key = 4, 64, jax.random.key(42)
    drive = _jax_search_drive(apply_fn, params, n, steps, key, coefs, 1, 0)
    pts, final, nm = JS.search_rollout(apply_fn, params, n, steps, key,
                                       coefs=JS.SearchCoefs(**coefs._asdict()),
                                       depth=1)
    np.testing.assert_array_equal(drive["points"], np.asarray(pts))
    np.testing.assert_array_equal(drive["final"], np.asarray(final))
    np.testing.assert_array_equal(drive["num_moves"], np.asarray(nm))

    spawns = np.full((steps, 2, n), 0.5, np.float32)
    for t, live in enumerate(drive["alive"]):
        spawns[t][:, live] = replay_draws(drive["moved"][t][live],
                                          drive["after"][t][live])
    res = play(model, torch.as_tensor(drive["boards0"]), steps,
               torch.as_tensor(spawns), greedy=True, search=(coefs, 1, 0))
    assert res.steps == len(drive["actions"])
    for t, (want, live) in enumerate(zip(drive["actions"], drive["alive"])):
        np.testing.assert_array_equal(res.actions[t].numpy()[live], want[live],
                                      err_msg=f"move {t}")
    np.testing.assert_array_equal(res.total_points.numpy(), drive["points"])
    np.testing.assert_array_equal(res.num_moves.numpy(), drive["num_moves"])
    np.testing.assert_array_equal(res.final_board.numpy(), drive["final"])
    assert drive["points"].min() > 0


def test_run_search_eval_chunks_and_repeats(small):
    """5 games at depth 2 run as one chunk of 5; at depth 3 as chunks of
    16 (one here); the same seed gives the same games."""
    _, _, model = small
    a = run_search_eval(model, 5, max_steps=6, env_seed=3, depth=2)
    b = run_search_eval(model, 5, max_steps=6, env_seed=3, depth=2)
    assert a["scores"] == b["scores"] and len(a["scores"]) == 5
    assert a["steps"] == 6
    c = run_search_eval(model, 3, max_steps=1, env_seed=3, depth=1)
    assert c["steps"] == 1 and len(c["scores"]) == 3


@pytest.mark.parametrize("ckpt", ["checkpoints_expA", "checkpoints_expG",
                                  "checkpoints_urm_r5"])
def test_load_search_coefs_matches_jax(ckpt):
    got = tcoefs(ROOT / ckpt)
    assert tuple(got) == tuple(jcoefs(ROOT / ckpt))
    assert got.sigma != 1.0 and got.mono > 0.0


def test_load_search_coefs_fallback_warns(tmp_path, capsys):
    """A missing or corrupt train_state falls back to pure-EV coefficients
    with a loud warning on stderr, as the JAX package does."""
    assert tcoefs(tmp_path) == TS.SearchCoefs()
    err = capsys.readouterr().err
    assert "WARNING" in err and "PURE-EV" in err
    (tmp_path / "train_state.json").write_text('{"config": {}}')
    (tmp_path / "train_state.npz").write_bytes(b"not a zip archive")
    assert tcoefs(tmp_path) == TS.SearchCoefs()
    assert tuple(jcoefs(tmp_path)) == tuple(TS.SearchCoefs())
    err = capsys.readouterr().err
    assert "CheckpointCorruptError" in err and "PURE-EV" in err


def test_cli_evaluate_search_prints_the_result_lines(capsys):
    cli.main(["evaluate", str(ROOT / "checkpoints_ht"), "--games", "1",
              "--search", "--env-seed", "7", "--device", "cpu"])
    captured = capsys.readouterr()
    out = captured.out.splitlines()
    assert out[2].startswith("Expectimax search eval (depth=1, points=0,")
    assert re.fullmatch(r"Eval Results - Max: \d+, Avg: \d+\.\d, Median: \d+", out[-2])
    assert re.fullmatch(r"Tiles Reached - 512: \d+\.\d%, 1024: \d+\.\d%, "
                        r"2048: \d+\.\d%", out[-1])
    assert "PURE-EV" in captured.err and "[search eval] chunk 1/1" in captured.err


def test_cli_forces_prune_at_depth3(monkeypatch, capsys):
    seen = {}
    monkeypatch.setattr("tpu2048_torch.train.evaluate.evaluate_checkpoint",
                        lambda path, **kw: seen.update(kw))
    cli.main(["evaluate", "ckpt", "--search", "--search-depth", "3"])
    assert seen["search_prune"] == 2 and seen["search_depth"] == 3
    assert seen["device"] == "cuda"
    assert "forcing --search-prune 2" in capsys.readouterr().out
