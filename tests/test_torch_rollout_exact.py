"""The port's exact-episodes rollout (tpu2048_torch/algo/rollout.py::rollout),
fed the fresh boards, actions and spawns of a JAX ``rollout``, reproduces
it: N games from fresh boards, some ending before the cap and some cut by
it, so the loop stops at the cap with lanes alive.

Tolerances: every integer and boolean record, the episode summaries and
``steps_executed`` bit-exact; logprobs, value_pred and entropy to 1e-5
(float32 forwards and log-softmaxes taken in another order); target_probs
exact (a one-hot)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_engine import one_torch_thread, replay_draws  # noqa: F401
from tpu2048.algo import rollout as JR
from tpu2048.env import engine as jengine
from tpu2048.models import MLPConfig as JMLPConfig
from tpu2048.models import mlp as jmlp
from tpu2048_torch.algo import rollout as TR
from tpu2048_torch.models.mlp import GameMLP, MLPConfig
from tpu2048_torch.train.checkpoint import params_to_state_dict

GAMES, CAP = 16, 120
FLOAT_TOL = 1e-5
FLOAT_FIELDS = ("logprobs", "value_pred", "entropy")


def jax_rollout(params, cfg, games, cap, seed):
    go = jax.jit(lambda p, k: JR.rollout(lambda q, x: jmlp.apply(q, cfg, x), p, k,
                                         games, cap))
    return jax.tree.map(np.asarray, go(params, jax.random.key(seed)))


def injected(traj, games, cap):
    """(boards, actions, spawns) that replay a JAX rollout: its fresh boards,
    its actions, and spawn draws from the pre-spawn and post-spawn boards of
    every played step (0.5 elsewhere: a finished game's move is illegal and
    spawns nothing)."""
    before = traj.board_before.astype(np.int32)
    action = traj.action.astype(np.int64)
    moves = np.asarray(jax.jit(jengine.all_moves)(jnp.asarray(before)).boards)
    spawns = np.full((cap, 2, games), 0.5, np.float32)
    for t in range(int(traj.steps_executed)):
        live = traj.valid[t]
        moved = moves[action[t], t, np.arange(games)]
        draws = replay_draws(moved[live], traj.board_after[t][live].astype(np.int32))
        spawns[t][:, live] = draws
    return (torch.as_tensor(before[0]), torch.as_tensor(action),
            torch.as_tensor(spawns))


def port_model(params, cfg):
    model = GameMLP(MLPConfig(**cfg.to_dict()))
    model.load_state_dict(params_to_state_dict(jax.tree.map(np.asarray, params)))
    return model.eval()


@pytest.fixture(scope="module")
def replay():
    cfg = JMLPConfig(hidden_dim=32, num_layers=2)
    params = jmlp.init(jax.random.key(3), cfg, zero_heads=False)
    jtraj = jax_rollout(params, cfg, GAMES, CAP, seed=9)
    boards, actions, spawns = injected(jtraj, GAMES, CAP)
    ttraj = TR.rollout(port_model(params, cfg), GAMES, CAP, boards=boards,
                       actions=actions, spawns=spawns)
    return jtraj, ttraj


def test_games_end_and_get_cut(replay):
    jtraj, _ = replay
    assert jtraj.ended.any() and not jtraj.ended.all()
    assert int(jtraj.steps_executed) == CAP


def test_records_replay_the_jax_rollout(replay):
    jtraj, ttraj = replay
    assert ttraj.steps_executed == int(jtraj.steps_executed)
    for name in TR.Trajectory._fields[:-1]:
        got, want = getattr(ttraj, name).numpy(), getattr(jtraj, name)
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if name in FLOAT_FIELDS:
            np.testing.assert_allclose(got, want, rtol=FLOAT_TOL, atol=FLOAT_TOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(ttraj.total_steps.numpy(), np.asarray(jtraj.total_steps))


def test_loop_stops_when_every_game_has_ended():
    """A cap no game reaches: the loop stops at the longest game's end, and
    the rows after it stay zero and invalid."""
    cfg = JMLPConfig(hidden_dim=16, num_layers=1)
    params = jmlp.init(jax.random.key(4), cfg, zero_heads=False)
    jtraj = jax_rollout(params, cfg, 4, 2000, seed=2)
    steps = int(jtraj.steps_executed)
    assert steps < 2000 and jtraj.ended.all() and steps == jtraj.num_moves.max()
    boards, actions, spawns = injected(jtraj, 4, 2000)
    ttraj = TR.rollout(port_model(params, cfg), 4, 2000, boards=boards, actions=actions,
                       spawns=spawns)
    assert ttraj.steps_executed == steps
    assert not ttraj.valid[steps:].any() and not ttraj.board_before[steps:].any()
    np.testing.assert_array_equal(ttraj.num_moves.numpy(), jtraj.num_moves)
    np.testing.assert_array_equal(ttraj.total_points.numpy(), jtraj.total_points)


def test_sampled_rollout_is_legal_and_repeatable():
    """Without injected draws: every played action legal, and the same
    generators give the same rollout."""
    model = GameMLP(MLPConfig(hidden_dim=16, num_layers=1), zero_heads=False,
                    generator=torch.Generator().manual_seed(0)).eval()

    def run():
        return TR.rollout(model, 8, 60, env_generator=torch.Generator().manual_seed(2),
                          action_generator=torch.Generator().manual_seed(3))

    traj, again = run(), run()
    taken = torch.gather(traj.action_mask, -1, traj.action.long()[..., None])[..., 0]
    assert not (taken & traj.valid).any()
    for name in TR.Trajectory._fields[:-1]:
        assert torch.equal(getattr(traj, name), getattr(again, name)), name
