"""The slice as a whole: the port's evaluation loop replays the JAX greedy
rollout of checkpoints_expG move for move, with the JAX spawns injected.
``jax_greedy_rollout`` and ``assert_greedy_loop_replays`` serve the other
model families' tests too."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_engine import one_torch_thread, replay_draws  # noqa: F401
from tpu2048.algo import rollout as jrollout
from tpu2048.env import engine as jengine
from tpu2048.train.evaluate import _apply_fn
from tpu2048.train.evaluate import load_model_checkpoint as jload
from tpu2048_torch.algo.rollout import masked_policy, play
from tpu2048_torch.models.encoding import encode_boards
from tpu2048_torch.train import cli
from tpu2048_torch.train.evaluate import load_model_checkpoint as tload
from tpu2048_torch.train.evaluate import run_eval

ROOT = Path(__file__).resolve().parent.parent
GAMES, STEPS = 8, 300


def jax_greedy_rollout(ckpt, games, steps):
    """The JAX package's greedy rollout of checkpoint ``ckpt`` (``games``
    games, ``steps`` steps, env key 12345) as numpy arrays."""
    params, cfg, mtype = jload(ROOT / ckpt)
    apply_fn = _apply_fn(cfg, mtype)
    go = jax.jit(lambda p, k, ek: jrollout.rollout(
        apply_fn, p, k, games, steps, env_key=ek, greedy=True))
    traj = go(params, jax.random.key(0), jax.random.key(12345))
    return jax.tree.map(np.asarray, traj)


def _first_divergence(model, traj, actions):
    """(step, game, top-2 logit gap) of the first action that differs."""
    steps = int(traj.steps_executed)
    for t in range(steps):
        valid = traj.valid[t]
        bad = np.nonzero(valid & (actions[t] != traj.action[t]))[0]
        if len(bad):
            g = int(bad[0])
            board = torch.as_tensor(traj.board_before[t, g:g + 1].astype(np.int32))
            with torch.no_grad():
                logits, _ = model(encode_boards(board))
            top = np.sort(logits[0].numpy())[::-1]
            return t, g, float(top[0] - top[1])
    return None


def assert_greedy_loop_replays(model, traj, games, steps):
    """The port's greedy ``play`` from the trajectory's first boards, with its
    spawns injected, takes the same actions and ends with the same points,
    move counts, ended flags and final boards."""
    n_steps = int(traj.steps_executed)
    boards0 = traj.board_before[0].astype(np.int32)
    spawns = np.full((steps, 2, games), 0.5, np.float32)
    moves = jax.jit(jengine.all_moves)
    for t in range(n_steps):
        before = traj.board_before[t].astype(np.int32)
        moved = np.asarray(moves(jnp.asarray(before)).boards)[
            traj.action[t].astype(np.int64), np.arange(games)]
        live = traj.valid[t]
        spawns[t][:, live] = replay_draws(moved[live],
                                          traj.board_after[t][live].astype(np.int32))
    res = play(model, torch.as_tensor(boards0), steps, torch.as_tensor(spawns),
               greedy=True)
    actions = res.actions.numpy()
    div = _first_divergence(model, traj, actions)
    assert div is None, "first divergence at step %d, game %d, top-2 logit gap %g" % div
    assert res.steps == n_steps
    np.testing.assert_array_equal(res.total_points.numpy(), traj.total_points)
    np.testing.assert_array_equal(res.num_moves.numpy(), traj.num_moves)
    np.testing.assert_array_equal(res.ended.numpy(), traj.ended)
    np.testing.assert_array_equal(res.final_board.numpy(), traj.final_board)
    assert n_steps == steps and traj.total_points.min() > 0


def test_greedy_loop_replays_jax_rollout():
    model, _, _ = tload(ROOT / "checkpoints_expG", device="cpu")
    assert_greedy_loop_replays(model, jax_greedy_rollout("checkpoints_expG", GAMES, STEPS),
                               GAMES, STEPS)


def test_masked_policy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(64, 4)).astype(np.float32)
    mask = rng.random((64, 4)) < 0.4
    mask[0] = True  # a finished game: no legal move
    want = jax.jit(jrollout.masked_policy)(jnp.asarray(logits), jnp.asarray(mask))
    got = masked_policy(torch.as_tensor(logits), torch.as_tensor(mask))
    # log_softmax and entropy are f32 reductions taken in another order.
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_sampled_play_takes_only_legal_moves():
    model, _, _ = tload(ROOT / "checkpoints_expG", device="cpu")
    gen = torch.Generator().manual_seed(1)
    boards = torch.as_tensor(np.zeros((16, 4, 4), np.int32))
    boards[:, 0, 0] = 1
    res = play(model, boards, 40, gen, greedy=False,
               action_generator=torch.Generator().manual_seed(2))
    assert res.steps == 40 and (res.num_moves == 40).all()
    assert (res.total_points >= 0).all() and not res.ended.any()


def test_run_eval_result_keys():
    model, _, _ = tload(ROOT / "checkpoints_expG", device="cpu")
    m = run_eval(model, 4, seed=0, max_steps=30, greedy=False)
    assert {"max_score", "avg_score", "median_score", "pct_512", "pct_1024",
            "pct_2048", "scores"} <= set(m)
    assert len(m["scores"]) == 4 and m["steps"] == 30
    again = run_eval(model, 4, seed=0, max_steps=30, greedy=False)
    assert again["scores"] == m["scores"]  # seeded generators: repeatable


def test_cli_evaluate_prints_the_result_lines(capsys):
    cli.main(["evaluate", str(ROOT / "checkpoints_expG"), "--games", "2",
              "--greedy", "--env-seed", "7", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"Eval Results - Max: \d+, Avg: \d+\.\d, Median: \d+", out[-2])
    assert re.fullmatch(r"Tiles Reached - 512: \d+\.\d%, 1024: \d+\.\d%, "
                        r"2048: \d+\.\d%", out[-1])
