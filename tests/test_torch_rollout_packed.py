"""The port's packed rollout (tpu2048_torch/algo/rollout.py::rollout_packed),
fed the actions, spawns and reset boards of a JAX ``rollout_packed`` chunk,
reproduces it: two chunks, so the carry crosses a chunk boundary, with lanes
that start a few moves from the end of their game and reset mid-chunk.

Tolerances: every integer record and the carry bit-exact; logprobs,
value_pred, entropy and boot_value to 1e-5 (float32 forwards and
log-softmaxes taken in another order)."""

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

LANES, HORIZON = 12, 12
FLOAT_TOL = 1e-5
FLOAT_FIELDS = ("logprobs", "value_pred", "entropy")
# A full board but for one hole: either of its two legal moves ends the
# game, whatever tile spawns.
NEAR_END = np.array([[7, 8, 6, 7], [5, 7, 9, 5], [7, 9, 6, 8], [6, 8, 7, 0]], np.int32)


def jax_chunks(cfg, params):
    """Two JAX packed chunks from a carry whose first four lanes are near
    their end; (carry0, [(traj, carry_out), (traj, carry_out)]) as numpy."""
    fresh = np.asarray(jengine.reset(jax.random.key(4), (LANES,)))
    boards = fresh.copy()
    boards[:4] = NEAR_END
    ep_moves = np.zeros(LANES, np.int32)
    ep_moves[:4] = 300
    ep_points = np.where(ep_moves > 0, 5000, 0).astype(np.int32)
    carry = JR.EnvCarry(jnp.asarray(boards), jax.random.key(11), jnp.asarray(ep_points),
                        jnp.asarray(ep_moves))
    carry0 = carry
    go = jax.jit(lambda p, k, c: JR.rollout_packed(
        lambda q, x: jmlp.apply(q, cfg, x), p, k, c, HORIZON))
    out = []
    for k in (1, 2):
        traj, carry = go(params, jax.random.key(k), carry)
        out.append((jax.tree.map(np.asarray, traj), carry))
    return carry0, out


def injected(traj, carry_out_boards):
    """(actions, spawns, resets) that replay a JAX chunk: spawn draws from
    the pre-spawn and post-spawn boards, and each ended lane's reset board
    (the next step's board, or the carry-out board after the last step)."""
    before = traj.board_before.astype(np.int32)
    action = traj.action.astype(np.int64)
    moves = np.asarray(jax.jit(jengine.all_moves)(jnp.asarray(before)).boards)
    spawns = np.zeros((HORIZON, 2, LANES), np.float32)
    resets = np.zeros((HORIZON, LANES, 4, 4), np.int32)
    nxt = np.concatenate([before[1:], np.asarray(carry_out_boards)[None]])
    for t in range(HORIZON):
        moved = moves[action[t], t, np.arange(LANES)]
        spawns[t] = replay_draws(moved, traj.board_after[t].astype(np.int32))
        resets[t] = np.where(traj.done_here[t][:, None, None], nxt[t], 0)
    return torch.as_tensor(action), torch.as_tensor(spawns), torch.as_tensor(resets)


@pytest.fixture(scope="module")
def replay():
    cfg = JMLPConfig(hidden_dim=32, num_layers=2)
    params = jmlp.init(jax.random.key(3), cfg, zero_heads=False)
    carry0, chunks = jax_chunks(cfg, params)
    model = GameMLP(MLPConfig(**cfg.to_dict()))
    model.load_state_dict(params_to_state_dict(jax.tree.map(np.asarray, params)))
    model.eval()
    carry = TR.EnvCarry(torch.tensor(np.asarray(carry0.boards)),
                        np.asarray(jax.random.key_data(carry0.env_key), np.uint32),
                        torch.tensor(np.asarray(carry0.ep_points)),
                        torch.tensor(np.asarray(carry0.ep_moves)))
    got = []
    for traj, jcarry in chunks:
        actions, spawns, resets = injected(traj, jcarry.boards)
        t_traj, carry = TR.rollout_packed(model, carry, HORIZON, actions=actions,
                                          spawns=spawns, resets=resets)
        got.append((t_traj, carry))
    return chunks, got


def test_chunks_cross_a_boundary_and_reset_mid_chunk(replay):
    chunks, _ = replay
    traj = chunks[0][0]
    assert traj.done_here[0, :4].all() and not traj.done_here[0, 4:].any()
    assert (traj.ep_score[0, :4] == 5000).all() and (traj.ep_len[0, :4] == 301).all()
    assert traj.ep_start[1, :4].all()  # reset lanes play on from fresh boards


@pytest.mark.parametrize("chunk", [0, 1])
def test_records_replay_the_jax_chunk(replay, chunk):
    (jtraj, jcarry), (ttraj, tcarry) = replay[0][chunk], replay[1][chunk]
    assert ttraj.steps_executed == int(jtraj.steps_executed) == HORIZON
    assert bool(ttraj.valid.all())
    for name in TR.PackedTrajectory._fields[:-2]:
        got, want = getattr(ttraj, name).numpy(), getattr(jtraj, name)
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if name in FLOAT_FIELDS:
            np.testing.assert_allclose(got, want, rtol=FLOAT_TOL, atol=FLOAT_TOL, err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_allclose(ttraj.boot_value.numpy(), jtraj.boot_value,
                               rtol=FLOAT_TOL, atol=FLOAT_TOL)
    np.testing.assert_array_equal(tcarry.boards.numpy(), np.asarray(jcarry.boards))
    np.testing.assert_array_equal(tcarry.ep_points.numpy(), np.asarray(jcarry.ep_points))
    np.testing.assert_array_equal(tcarry.ep_moves.numpy(), np.asarray(jcarry.ep_moves))


def test_sampled_chunk_is_legal_and_repeatable():
    """Without injected draws: every action legal, and the same generators
    give the same chunk."""
    model = GameMLP(MLPConfig(hidden_dim=16, num_layers=1), zero_heads=False,
                    generator=torch.Generator().manual_seed(0)).eval()

    def run():
        env = torch.Generator().manual_seed(2)
        carry = TR.init_env_carry(np.array([0, 1], np.uint32), 8, "cpu", env)
        return TR.rollout_packed(model, carry, 20, env_generator=env,
                                 action_generator=torch.Generator().manual_seed(3))

    (traj, carry), (again, carry2) = run(), run()
    taken = torch.gather(traj.action_mask, -1, traj.action.long()[..., None])
    assert not taken.any()
    for name in TR.PackedTrajectory._fields[:-1]:
        assert torch.equal(getattr(traj, name), getattr(again, name)), name
    assert torch.equal(carry.boards, carry2.boards)
