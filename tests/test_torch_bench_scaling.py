"""scripts/torch_bench_scaling.py, the port's data-parallel scaling harness,
against scripts/bench_scaling.py, on the CPU (Gloo ranks for the port, the
conftest's virtual CPU mesh for the JAX package).

* The configuration: the JAX harness's ``bench_mesh`` is run with
  ``tpu2048.parallel.make_sharded_train_step`` patched to record what it is
  given and the first call of its step, and to stop there (nothing is
  compiled): its TrainConfig equals the port's ``bench_config`` field for
  field, its OptimizerConfig the port's, its train step and entropy weight
  ``TRAIN_STEP + 1`` and ``BETA``.
* The step at D = 1 and D = 2, exact and packed, at tiny widths (H=16, 12
  games or lanes a rank, packed horizon 12): the JAX package's sharded step
  of that configuration without dropout (initial parameters from
  ``bench_mesh``'s ``key(0)``, carried across) against the harness's ``make_step``, each
  rank replaying its JAX shard's draws: counts and env steps exact, the
  mean scores to two float32 ulps, the zero-reward share to one row, the
  moments and the other statistics
  1e-5 relative, loss statistics 2e-4
  relative, parameters 5e-4 absolute (bfloat16 Newton-Schulz), as
  ``tests/test_torch_parallel.py`` holds the same step; the ranks'
  parameters bit-identical, and ``same_on_every_rank`` true, then false
  once rank 1 nudges a parameter.
* The whole harness through ``launch`` at D = 1 and 2 (H=16): its rows,
  the env steps of each run, the efficiency against D = 1.
* Every run of a row, warm-up and timed, starts from the initial
  parameters, a fresh optimizer state and the initial moments, as every run
  of ``bench_mesh`` does.
* ``cuda`` without a card raises; more cards than the machine has raises,
  naming the count, before anything runs; ``--share-card`` off the card
  raises.
"""

import dataclasses
import importlib.util
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scripts import torch_bench_scaling as TBS
from tests import torch_ranks
from tests.test_torch_engine import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_optim import _flat
from tests.test_torch_parallel import rank_draws
from tests.test_torch_rollout_packed import HORIZON, LANES
from tests.test_torch_train import EXACT, LOSS_STATS
from tpu2048.algo import advantage as JA
from tpu2048.ops import optimizer as jopt
from tpu2048.parallel import make_mesh as jmake_mesh
from tpu2048.parallel import make_sharded_train_step
from tpu2048.parallel.train_step import init_sharded_env_carry as jinit_carry
from tpu2048.train import loop as JLOOP
from tpu2048_torch.algo import advantage as TA
from tpu2048_torch.ops import optimizer as topt
from tpu2048_torch.parallel import mesh as TM
from tpu2048_torch.train import loop as TLOOP
from tpu2048_torch.train.checkpoint import params_to_state_dict

ROOT = Path(__file__).resolve().parent.parent
# bench_mesh's arguments here: 12 games or lanes a rank (the packed replay's
# LANES), the packed horizon HORIZON (12), games capped at 40 moves,
# minibatches of 64 rows a rank (10 in an exact step, 3 in a packed one).
ARGS = dict(envs_per_device=LANES, max_steps=40, batch_per_device=64, horizon=HORIZON)
HIDDEN = 16
_BENCH_CONFIG = TBS.bench_config  # the harness's own: the tests patch it with narrow_config


def narrow_config(*args, **kw):
    """The harness's configuration at H=16 (it is built in this process and
    sent to the ranks)."""
    return dataclasses.replace(_BENCH_CONFIG(*args, **kw), hidden_size=HIDDEN)


# The harness trains with the default dropout 0.1, whose masks the JAX
# package draws from its key and the port from its generator: the replay
# turns it off on both sides (the configuration test holds the 0.1).
NO_DROPOUT = dict(dropout=0.0)
# Parameters: bfloat16 Newton-Schulz, as tests/test_torch_parallel.py holds
# the same step. The engines drift apart with each minibatch: from the
# harness's zero heads, 2.7e-4 after 10 (exact, D = 1), 6.1e-4 after 37 at
# 16 rows a rank.
PARAM_ATOL = 5e-4
# Means of integer scores: the same float32 sum, divided by the count here
# and multiplied by its reciprocal in XLA, so up to an ulp apart (1.2e-7
# relative); every other statistic in EXACT is held equal.
MEANS = ("avg_score", "batch_avg_score")
MEAN_RTOL = 2.5e-7
# zero_reward_pct, the share of rows whose shaped reward is exactly 0.0:
# XLA fuses 0.1 * points + (gamma * mono_after - mono_before) into a
# multiply-add, so a row whose terms cancel in float32 (20 points, mono 2
# then 0) can be 3e-8 there. It is held to one row's share.


class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def jax_harness():
    """scripts/bench_scaling.py as a module (importing it sets
    ``jax_platforms`` to JAX_PLATFORMS, the conftest's 'cpu')."""
    spec = importlib.util.spec_from_file_location("jax_bench_scaling",
                                                  ROOT / "scripts" / "bench_scaling.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    assert jax.devices()[0].platform == "cpu"
    return module


def recorded_call(jax_harness, n: int, packed: bool) -> dict:
    """What ``bench_mesh(n, ...)`` hands ``make_sharded_train_step`` and
    the first call of its step."""
    got = {}

    def fake(mesh, cfg, apply_eval, apply_train, labels, opt_config, **kw):
        got.update(mesh=mesh, cfg=cfg, opt=opt_config, labels=labels, kw=kw)

        def step(*args):
            got["args"] = args
            raise _Stop

        return step

    with mock.patch("tpu2048.parallel.make_sharded_train_step", fake), pytest.raises(_Stop):
        jax_harness.bench_mesh(n, ARGS["envs_per_device"], ARGS["max_steps"],
                               ARGS["batch_per_device"], packed=packed,
                               horizon=ARGS["horizon"])
    return got


@pytest.mark.parametrize("packed", [False, True], ids=["exact", "packed"])
@pytest.mark.parametrize("n", [1, 2])
def test_config_is_the_jax_harness(jax_harness, n, packed):
    got = recorded_call(jax_harness, n, packed)
    port = TBS.bench_config(n, packed=packed, device="cpu", **ARGS)
    want = dataclasses.asdict(got["cfg"])
    assert {k: v for k, v in dataclasses.asdict(port).items() if k != "device"} == want
    assert want["hidden_size"] == 196 and got["mesh"].devices.size == n and got["kw"] == {}
    assert dataclasses.asdict(topt.OptimizerConfig(**TBS.OPT)) == dataclasses.asdict(got["opt"])
    *_, train_step, beta = got["args"]
    assert int(train_step) == TBS.TRAIN_STEP + 1
    assert np.float32(beta) == np.float32(TBS.BETA)
    if packed:  # bench_mesh's lanes: init_sharded_env_carry(mesh, key(7), lanes)
        carry = got["args"][3]
        want_carry = jinit_carry(jmake_mesh(n), jax.random.key(7), port.lanes)
        np.testing.assert_array_equal(np.asarray(carry.boards), np.asarray(want_carry.boards))


def jax_case(n: int, packed: bool) -> tuple:
    """The JAX sharded step of the harness's configuration at H=16 on a
    virtual mesh of ``n``, from ``bench_mesh``'s key(0) initial parameters:
    (the rank job's arguments, (params, moments, outputs, trajectory))."""
    cfg = dataclasses.replace(
        JLOOP.TrainConfig(**{k: v for k, v in dataclasses.asdict(
            TBS.bench_config(n, packed=packed, **ARGS)).items() if k != "device"}),
        hidden_size=HIDDEN, **NO_DROPOUT)
    _, init_fn, apply_eval, apply_train, labels_fn = JLOOP.build_model(cfg)
    params = init_fn(jax.random.key(0))
    labels = labels_fn(params)
    mesh = jmake_mesh(n)
    step = make_sharded_train_step(mesh, cfg, apply_eval, apply_train, labels,
                                   jopt.OptimizerConfig(**TBS.OPT))
    key = jax.random.key(2)
    state = (params, jopt.init(params, labels), JA.RtgMoments.initial())
    scalars = (jnp.int32(TBS.TRAIN_STEP + 1), jnp.float32(TBS.BETA))
    local = cfg.lanes // n
    if packed:
        carry = jinit_carry(mesh, jax.random.key(7), cfg.lanes)
        p, _, m, carry1, traj, out = step(*state, carry, key, *scalars)
        traj = jax.tree.map(np.asarray, traj)
        boards, points, moves = (np.array(x) for x in (carry.boards, carry.ep_points,
                                                       carry.ep_moves))
        draws = rank_draws(dataclasses.asdict(cfg), key, traj, local,
                           carry_boards=np.asarray(carry1.boards), ranks=n)
        carries = [(boards[sl], points[sl], moves[sl])
                   for sl in (slice(r * local, (r + 1) * local) for r in range(n))]
    else:
        p, _, m, traj, out = step(*state, key, *scalars)
        traj = jax.tree.map(np.asarray, traj)
        draws = rank_draws(dataclasses.asdict(cfg), key, traj, local, ranks=n)
        carries = None
    sd = {k: v.numpy() for k, v in
          params_to_state_dict(jax.tree.map(np.asarray, params)).items()}
    job = dict(args=dict(ARGS, packed=packed, device="cpu"),
               overrides=dict(NO_DROPOUT, hidden_size=HIDDEN),
               state_dict=sd, draws=draws[0], plans=draws[1], perms=draws[2], carries=carries)
    return job, (p, m, out, traj)


@pytest.fixture(scope="module")
def replays(tmp_path_factory):
    """Both modes at D = 1 (a group of one, in this process) and D = 2 (two
    spawned ranks)."""
    tmp = tmp_path_factory.mktemp("bench")
    refs, got = {}, {}
    for n in (1, 2):
        jobs = []
        for packed in (False, True):
            name = f"{'packed' if packed else 'exact'}-{n}"
            job, refs[name] = jax_case(n, packed)
            jobs.append((name, "bench_replay", job))
        url = f"file://{tmp}/rendezvous{n}"
        ranks = ([torch_ranks.run(0, 1, url, jobs)] if n == 1 else
                 TM.spawn(torch_ranks.run, 2, (2, url, jobs), timeout_s=600))
        for name, _, _ in jobs:
            got[name] = [r[name] for r in ranks]
    return refs, got


@pytest.mark.parametrize("mode", ["exact", "packed"])
@pytest.mark.parametrize("n", [1, 2])
def test_harness_step_replays_the_jax_step(replays, n, mode):
    refs, got = replays
    jparams, jmoments, jout, jtraj = refs[f"{mode}-{n}"]
    ranks = got[f"{mode}-{n}"]
    want = dict(zip(JLOOP.SCALAR_KEYS, np.asarray(jout["scalars"]).tolist()))
    for res in ranks:
        for k in TLOOP.SCALAR_KEYS:
            if k in MEANS:
                np.testing.assert_allclose(res["scalars"][k], want[k], rtol=MEAN_RTOL, atol=0,
                                           err_msg=k)
            elif k == "zero_reward_pct":
                assert abs(res["scalars"][k] - want[k]) <= 100.0 / want["env_steps"] + 1e-4
            elif k in EXACT:
                assert res["scalars"][k] == want[k], k
            elif k in LOSS_STATS:
                np.testing.assert_allclose(res["scalars"][k], want[k], rtol=2e-4, atol=0,
                                           err_msg=k)
            else:
                np.testing.assert_allclose(res["scalars"][k], want[k], rtol=1e-5,
                                           atol=1e-5 * max(abs(want[k]), 1.0), err_msg=k)
        for g, w in zip(res["moments"], jmoments):
            np.testing.assert_allclose(g, float(w), rtol=1e-5)
        for name, w in _flat(jparams).items():
            np.testing.assert_allclose(res["params"][name], w, rtol=0, atol=PARAM_ATOL,
                                       err_msg=name)
        assert res["steps_executed"] == int(jtraj.steps_executed)
        assert res["same"] and res["same_after_nudge"] == (n == 1)
    for name, p in ranks[0]["params"].items():
        np.testing.assert_array_equal(p, ranks[-1]["params"][name], err_msg=name)
    lanes = ARGS["envs_per_device"] * n
    if mode == "packed":
        assert want["env_steps"] == lanes * ARGS["horizon"]
    else:
        assert want["env_steps"] == int(jtraj.num_moves.sum())
    assert want["augmented_samples"] > 0 and want["num_batches"] >= 2


@pytest.mark.parametrize("mode", ["exact", "packed"])
def test_harness_rows_through_launch(mode):
    """The harness at D = 1 (in process) and D = 2 (spawned Gloo ranks):
    WARMUP untimed and two timed steps a row, every step's env steps the
    global count, D = 1's efficiency 1."""
    with mock.patch.object(TBS, "bench_config", narrow_config):
        rows = TBS.run([1, 2], [mode], repeats=2, device="cpu", say=lambda s: None, **ARGS)
    assert [(r["mode"], r["mesh"], r["ranks"]) for r in rows] == [(mode, 1, 1), (mode, 2, 2)]
    for r in rows:
        assert [run["timed"] for run in r["runs"]] == [False] * TBS.WARMUP + [True, True]
        lanes = ARGS["envs_per_device"] * r["mesh"]
        for run in r["runs"]:
            assert run["seconds"] > 0
            if mode == "packed":
                assert run["env_steps"] == lanes * ARGS["horizon"] and run["trips"] is None
            else:
                assert lanes <= run["env_steps"] <= lanes * run["trips"]
                assert 0 < run["trips"] <= ARGS["max_steps"]
        rates = r["env_steps_per_s_runs"]
        assert len(rates) == 2 and r["env_steps_per_s"] == max(rates)
        assert 0 <= r["spread"] < 1 and r["launches"] == 0  # the plain merge on the CPU
        assert r["backend"] == "gloo" and not r["shared_card"]
    assert rows[0]["weak_scaling_efficiency"] == 1.0
    assert rows[1]["weak_scaling_efficiency"] == pytest.approx(
        rows[1]["env_steps_per_s"] / (2 * rows[0]["env_steps_per_s"]))


def test_cuda_without_a_card_raises():
    with pytest.raises(RuntimeError, match="cuda"):
        TBS.run([1], ["packed"], device="cuda", say=lambda s: None, **ARGS)
    with pytest.raises(RuntimeError, match="cuda"):
        TBS.main(["--devices", "1", "--modes", "packed"])


def test_more_cards_than_the_machine_has_raise_before_running():
    with mock.patch.object(torch.cuda, "is_available", lambda: True), \
            mock.patch.object(torch.cuda, "device_count", lambda: 1), \
            mock.patch.object(TBS, "bench_mesh") as bench:
        with pytest.raises(RuntimeError, match="this machine has 1"):
            TBS.run([1, 2], device="cuda", say=lambda s: None)
        TBS.check_sizes([1, 2], "cuda", share_card=True)  # one card for every rank
    bench.assert_not_called()
    with pytest.raises(ValueError, match="--share-card"):
        TBS.check_sizes([1, 2], "cpu", share_card=True)


def _state(model) -> dict:
    return {k: v.detach().clone().numpy() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("mode", ["exact", "packed"])
def test_every_run_starts_from_the_initial_state(mode):
    """bench_rank (D = 1, no group): each step it warms up with or times is
    handed the initial parameters, a fresh optimizer state and the initial
    moments, with the key (0, 1 + the run's index); the steps do train the
    model, which ends away from the initial parameters."""
    models, calls, make_step = [], [], TBS.make_step

    def recording_make_step(group, cfg, state_dict=None):
        model, step, opt_state = make_step(group, cfg, state_dict)
        models.append((model, _state(model)))

        def step_seen(opt_state, moments, key, *args):
            bufs = (*opt_state.momentum.values(), *opt_state.m.values(), *opt_state.v.values())
            calls.append(dict(params=_state(model), key=key, opt_step=opt_state.step,
                              opt_zero=not any(b.any() for b in bufs),
                              moments=[float(m) for m in moments]))
            return step(opt_state, moments, key, *args)

        return model, step_seen, opt_state

    cfg = narrow_config(1, packed=mode == "packed", device="cpu", **ARGS)
    with mock.patch.object(TBS, "make_step", recording_make_step):
        runs = TBS.bench_rank(cfg, None, repeats=2)["runs"]
    [(model, initial)] = models
    assert len(runs) == len(calls) == TBS.WARMUP + 2
    fresh_moments = [float(m) for m in TA.RtgMoments.initial()]
    for i, call in enumerate(calls):
        assert call["key"] == (0, 1 + i) and call["opt_step"] == 0 and call["opt_zero"]
        assert call["moments"] == fresh_moments
        for name, w in initial.items():
            np.testing.assert_array_equal(call["params"][name], w, err_msg=name)
    final = _state(model)
    assert any(not np.array_equal(final[k], w) for k, w in initial.items())
