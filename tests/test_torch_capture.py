"""The port's best-episode recorder (tpu2048_torch/algo/capture.py).

* ``record_step`` driven by the JAX package's own packed trips, one trip at
  a time from a resumed carry (three lanes tainted by ``mark_resumed``,
  ending in the first trip with scores that would win), at a cap that
  truncates every completion and at one that truncates none: every recorder
  field equal after every trip, bit for bit.
* ``rollout_packed(recorder=...)`` replaying two JAX chunks with the
  recorder: the recorder equal (entropies to 1e-5, the float32 policy's).
* The checks of tests/test_capture.py on the port's own recorder, from its
  own generators: the committed score is the best completion's, the
  episode replays move for move through the engine, truncation keeps the
  true length."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import random_board_np
from tests.test_torch_engine import one_torch_thread, replay_draws  # noqa: F401
from tpu2048.algo import capture as JC
from tpu2048.algo import rollout as JR
from tpu2048.env import engine as jengine
from tpu2048.models import MLPConfig as JMLPConfig
from tpu2048.models import mlp as jmlp
from tpu2048_torch.algo import capture as TC
from tpu2048_torch.algo import rollout as TR
from tpu2048_torch.env import engine as tengine
from tpu2048_torch.models.mlp import GameMLP, MLPConfig
from tpu2048_torch.train.checkpoint import params_to_state_dict

LANES, TRIPS = 12, 80
NEAR_END = np.array([[7, 8, 6, 7], [5, 7, 9, 5], [7, 9, 6, 8], [6, 8, 7, 0]], np.int32)
FLOAT_TOL = 1e-5
CFG = JMLPConfig(hidden_dim=32, num_layers=1)


def start_carry():
    """Dense boards (games end within tens of moves), the first three one
    move from their end and mid-episode (300 moves, 5,000 points)."""
    rng = np.random.default_rng(0)
    boards = np.stack([random_board_np(rng, max_exp=7, p_zero=0.2) for _ in range(LANES)])
    boards[:3] = NEAR_END
    ep_moves = np.zeros(LANES, np.int32)
    ep_moves[:3] = 300
    return JR.EnvCarry(jnp.asarray(boards), jax.random.key(11),
                       jnp.asarray(np.where(ep_moves > 0, 5000, 0).astype(np.int32)),
                       jnp.asarray(ep_moves))


def as_numpy(rec):
    return {k: np.asarray(v) for k, v in rec._asdict().items()}


def to_port(rec: dict) -> TC.EpisodeRecorder:
    return TC.EpisodeRecorder(**{k: torch.as_tensor(np.array(v)) for k, v in rec.items()})


def jax_trips(cap, params):
    """[(carry before, one-trip trajectory, recorder after)] as numpy, and
    the recorder before the first trip."""
    carry = start_carry()
    rec = JC.mark_resumed(JC.init_recorder(LANES, cap), carry.ep_moves)
    rec0 = as_numpy(rec)
    go = jax.jit(lambda p, k, c, r: JR.rollout_packed(
        lambda q, x: jmlp.apply(q, CFG, x), p, k, c, 1, recorder=r))
    out = []
    for t in range(TRIPS):
        before = jax.tree.map(np.asarray, carry._replace(env_key=jnp.zeros(2)))
        traj, carry, rec = go(params, jax.random.key(100 + t), carry, rec)
        out.append((before, jax.tree.map(np.asarray, traj), as_numpy(rec)))
    return rec0, out


@pytest.fixture(scope="module")
def params():
    return jmlp.init(jax.random.key(7), CFG, zero_heads=False)


@pytest.fixture(scope="module", params=[12, 96], ids=["cap12_truncates", "cap96"])
def trips(request, params):
    return request.param, *jax_trips(request.param, params)


def test_trips_cover_taint_truncation_and_ties(trips):
    cap, _, steps = trips
    done = [(t, n) for t, (_, traj, _) in enumerate(steps)
            for n in np.nonzero(traj.done_here[0])[0]]
    assert [n for t, n in done if t == 0] == [0, 1, 2]  # the tainted lanes end first
    assert steps[0][2]["best_score"] == 0  # ... and commit nothing
    assert len(done) >= 8 and len({t for t, _ in done}) < len(done)  # two in one trip
    commits = [t for t, (_, _, r) in enumerate(steps)
               if r["best_score"] != (steps[t - 1][2]["best_score"] if t else 0)]
    assert 3 <= len(commits) < len(done) - 3  # some completions do not win
    true_len, best_len = steps[-1][2]["best_true_len"], steps[-1][2]["best_len"]
    assert (true_len > best_len == cap) if cap == 12 else (true_len == best_len < cap)


def test_record_step_matches_jax_after_every_trip(trips):
    _, rec0, steps = trips
    rec = to_port(rec0)

    def t(x):
        return torch.as_tensor(np.array(x))

    for i, (carry, traj, want) in enumerate(steps):
        points = traj.points[0]
        rec = TC.record_step(
            rec, ep_moves=t(carry.ep_moves), board_before=t(traj.board_before[0]).int(),
            board_after=t(traj.board_after[0]).int(), action=t(traj.action[0]).long(),
            points=t(points), entropy=t(traj.entropy[0]), done=t(traj.done_here[0]),
            ep_points_new=t(carry.ep_points + points), ep_moves_new=t(carry.ep_moves + 1))
        for k, w in want.items():
            got = getattr(rec, k).numpy()
            assert got.dtype == w.dtype and got.shape == w.shape, k
            np.testing.assert_array_equal(got, w, err_msg=f"trip {i}: {k}")


def injected(trajs, carry_out_boards):
    """(actions, spawns, resets) replaying a JAX chunk of any size."""
    before = trajs.board_before.astype(np.int32)
    horizon, lanes = before.shape[:2]
    moves = np.asarray(jax.jit(jengine.all_moves)(jnp.asarray(before)).boards)
    spawns = np.zeros((horizon, 2, lanes), np.float32)
    resets = np.zeros((horizon, lanes, 4, 4), np.int32)
    nxt = np.concatenate([before[1:], np.asarray(carry_out_boards)[None]])
    action = trajs.action.astype(np.int64)
    for t in range(horizon):
        moved = moves[action[t], t, np.arange(lanes)]
        spawns[t] = replay_draws(moved, trajs.board_after[t].astype(np.int32))
        resets[t] = np.where(trajs.done_here[t][:, None, None], nxt[t], 0)
    return torch.as_tensor(action), torch.as_tensor(spawns), torch.as_tensor(resets)


def test_rollout_packed_records_as_the_jax_chunk(params):
    cap, horizon = 64, 40
    carry = start_carry()
    jrec = JC.mark_resumed(JC.init_recorder(LANES, cap), carry.ep_moves)
    model = GameMLP(MLPConfig(**CFG.to_dict()))
    model.load_state_dict(params_to_state_dict(jax.tree.map(np.asarray, params)))
    model.eval()
    tcarry = TR.EnvCarry(torch.as_tensor(np.array(carry.boards)), np.zeros(2, np.uint32),
                         torch.as_tensor(np.array(carry.ep_points)),
                         torch.as_tensor(np.array(carry.ep_moves)))
    trec = TC.mark_resumed(TC.init_recorder(LANES, cap), tcarry.ep_moves)
    go = jax.jit(lambda p, k, c, r: JR.rollout_packed(
        lambda q, x: jmlp.apply(q, CFG, x), p, k, c, horizon, recorder=r))
    for chunk in range(2):
        jtraj, carry, jrec = go(params, jax.random.key(chunk), carry, jrec)
        jtraj = jax.tree.map(np.asarray, jtraj)
        actions, spawns, resets = injected(jtraj, carry.boards)
        _, tcarry, trec = TR.rollout_packed(model, tcarry, horizon, actions=actions,
                                            spawns=spawns, resets=resets, recorder=trec)
        for k, w in as_numpy(jrec).items():
            got = getattr(trec, k).numpy()
            if k.endswith("entropy"):
                np.testing.assert_allclose(got, w, rtol=FLOAT_TOL, atol=FLOAT_TOL, err_msg=k)
            else:
                np.testing.assert_array_equal(got, w, err_msg=f"chunk {chunk}: {k}")
    assert int(trec.best_score) > 0


def port_chunks(lanes=16, horizon=64, chunks=6, cap=2048, seed=0):
    """The port's own packed chunks with a recorder: (recorder, every
    completion's (score, length))."""
    model = GameMLP(MLPConfig(hidden_dim=32, num_layers=1), zero_heads=False,
                    generator=torch.Generator().manual_seed(7)).eval()
    env = torch.Generator().manual_seed(seed)
    carry = TR.init_env_carry(np.zeros(2, np.uint32), lanes, "cpu", env)
    rec = TC.init_recorder(lanes, cap)
    completions = []
    for c in range(chunks):
        traj, carry, rec = TR.rollout_packed(
            model, carry, horizon, env_generator=env, recorder=rec,
            action_generator=torch.Generator().manual_seed(seed + 1 + c))
        done = traj.done_here
        completions += list(zip(traj.ep_score[done].tolist(), traj.ep_len[done].tolist()))
    return rec, completions


def test_port_recorder_keeps_the_best_completion():
    rec, completions = port_chunks()
    assert completions
    best = max(completions)
    assert int(rec.best_score) == best[0]
    assert int(rec.best_true_len) in {n for s, n in completions if s == best[0]}
    assert int(rec.best_len) == min(int(rec.best_true_len), rec.best_action.shape[0])


def test_port_recorded_episode_replays_through_the_engine():
    rec, _ = port_chunks()
    n = int(rec.best_len)
    assert n > 0 and int(rec.best_true_len) == n
    before = rec.best_before[:n].int()
    after = rec.best_after[:n].int()
    action = rec.best_action[:n].long()
    points = rec.best_points[:n]
    assert int(points.sum()) == int(rec.best_score)
    assert torch.equal(after[:-1], before[1:])
    moves = tengine.all_moves(before)
    merged = moves.boards[action, torch.arange(n)]
    assert torch.equal(moves.scores[action, torch.arange(n)], points)
    differ = (merged != after).sum((1, 2))
    for t in range(n):
        if int(differ[t]) == 0:
            continue  # no spawn: only the terminal move on a full board
        assert int(differ[t]) == 1
        r, c = torch.nonzero(merged[t] != after[t])[0].tolist()
        assert merged[t, r, c] == 0 and int(after[t, r, c]) in (1, 2)
    assert tengine.all_moves(after[-1:]).action_mask.all()


def test_port_truncation_keeps_the_true_length():
    rec, completions = port_chunks(cap=8, chunks=4)
    assert completions and int(rec.best_score) == max(completions)[0]
    assert int(rec.best_true_len) > 8 and int(rec.best_len) == 8
