"""The port's data-parallel trainer (``make_sharded_train_step`` over a
tpu2048_torch/parallel/ process group) against tpu2048.parallel, on the
CPU: Gloo ranks spawned for the port (tests/torch_ranks.py), the
conftest's 8-device mesh for the JAX package.

* D=2, exact episodes (also under ``--anchor-kl``) and packed lanes, the
  KL diagnostic on: each port rank replays its JAX shard's draws
  (``fold_in(key, d)`` then split: the shard's slice of the global
  trajectory, ``jax_process_draws``) and matches
  ``make_sharded_train_step``: parameters 5e-4 absolute (bfloat16
  Newton-Schulz), moments, the advantage and the statistics 1e-5 relative,
  loss statistics 2e-4 relative, counts, scores, tiles, ``best_idx`` and
  ``env_steps`` exact (tests/test_torch_train.py's tolerances); the KL
  diagnostic 1e-1 relative (``KL_RTOL``: bfloat16 Newton-Schulz); the
  ranks' parameters and statistics bit-identical.
* ``--critic`` reaches the sharded objective; expert iteration runs at D=2
  with the live teacher and with a frozen ``--expert-src`` teacher, which is
  the loaded one.
* D=4: the moments equal a host recomputation over the gathered
  trajectory (1e-5 relative), ``samples == env_steps``, augmentation live,
  ``best_idx`` global, and the packed lanes continue across two steps.
* ``make_mesh`` shapes and its ``ValueError``; the tensor-parallel forward
  at 'model' axis 2 equals the single-rank forward to 1e-5.
* D=1 through a process group equals the single-device trainer bit for bit.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_ranks
from tests.test_torch_engine import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_optim import _flat
from tests.test_torch_rollout_exact import injected as injected_exact
from tests.test_torch_rollout_packed import LANES, HORIZON, NEAR_END
from tests.test_torch_rollout_packed import injected as injected_packed
from tests.test_torch_train import EXACT, LOSS_STATS, jax_process_draws
from tpu2048.algo import advantage as JA
from tpu2048.models import MLPConfig as JMLPConfig
from tpu2048.models import mlp as jmlp
from tpu2048.ops import optimizer as jopt
from tpu2048.parallel import make_mesh as jmake_mesh
from tpu2048.parallel import make_sharded_train_step
from tpu2048.parallel.train_step import init_sharded_env_carry as jinit_carry
from tpu2048.train import loop as JLOOP
from tpu2048_torch.algo import advantage as TA
from tpu2048_torch.algo import update as TU
from tpu2048_torch.models.mlp import GameMLP, MLPConfig
from tpu2048_torch.parallel import mesh as TM
from tpu2048_torch.train import cli
from tpu2048_torch.train import loop as TLOOP
from tpu2048_torch.train.checkpoint import params_to_state_dict

BASE = dict(hidden_size=32, num_layers=2, dropout=0.0, upsample_ratio=0.25,
            points_weight=0.1, monotonicity_weight=1.0, gamma=0.995, rtg_beta=0.99,
            warmup_steps=0, steps=10, kl_diagnostic=True, learning_rate=1e-3,
            critic_lr=1e-4, entropy_strength=0.02, critic_strength=0.2)
EXACT_D2 = dict(BASE, num_episodes=16, batch_size=96, scan_cap=100)
ANCHORED_D2 = dict(EXACT_D2, anchor_kl=0.5)  # the anchor: the step's starting policy
PACKED_D2 = dict(BASE, packed=True, lanes=2 * LANES, horizon=HORIZON, batch_size=96)
EXPERT_D2 = dict(BASE, hidden_size=16, num_layers=1, num_episodes=4, batch_size=8,
                 scan_cap=40, expert_iter=True, expert_depth=1)
EXACT_D4 = dict(BASE, hidden_size=16, num_episodes=16, batch_size=32, scan_cap=64)
PACKED_D4 = dict(EXACT_D4, packed=True, lanes=16, horizon=24, batch_size=64)
TRAIN_STEP = 4  # 0-indexed: the JAX step's jnp.int32(5)
# The KL diagnostic against the JAX step. It is quadratic in each
# minibatch's policy update, and the updates of the 4-row action head differ
# between the two engines by 1.5-3.4% (their non-uniform part, on these
# inputs) through bfloat16 Newton-Schulz, whose products accumulate in
# bfloat16: so the KL by up to about 7%. A wrong reduction over the ranks (a
# rank's sum left out, a local denominator) is off by a factor of about 2.
# The ranks' KL scalars are also held equal to each other exactly.
KL_RTOL = 1e-1


def spawn_ranks(size: int, jobs: list, tmp) -> list:
    return TM.spawn(torch_ranks.run, size, (size, f"file://{tmp}/rendezvous", jobs),
                    timeout_s=600)


def jax_setup(cfg: dict):
    mcfg = JMLPConfig(hidden_dim=cfg["hidden_size"], num_layers=cfg["num_layers"],
                      dropout=0.0)
    params = jmlp.init(jax.random.key(3), mcfg, zero_heads=False)
    labels = jmlp.param_labels(params)
    apply_eval = lambda p, x: jmlp.apply(p, mcfg, x)  # noqa: E731
    anchor = (apply_eval, params, cfg["anchor_kl"]) if cfg.get("anchor_kl") else None
    step = make_sharded_train_step(
        jmake_mesh(2), JLOOP.TrainConfig(**cfg), apply_eval,
        lambda p, x, rng: jmlp.apply(p, mcfg, x, train=True, rng=rng), labels,
        jopt.OptimizerConfig(**torch_ranks.OPT), anchor=anchor)
    sd = {k: v.numpy() for k, v in params_to_state_dict(jax.tree.map(np.asarray, params)).items()}
    return params, labels, step, sd


def shard(traj, d: int, n: int):
    """Shard d's slice of a global (T, N) trajectory (numpy)."""
    sl = slice(d * n, (d + 1) * n)
    out = {}
    for k, v in traj._asdict().items():
        if k == "steps_executed":
            out[k] = v
        elif k in ("final_board", "total_points", "num_moves", "ended", "boot_value"):
            out[k] = v[sl]
        else:
            out[k] = v[:, sl]
    return type(traj)(**out)


def rank_draws(jcfg: dict, key, traj, local: int, carry_boards=None, ranks: int = 2) -> tuple:
    """(draws, plan, perm) of each of the ``ranks`` JAX shards for the
    port's ranks."""
    draws, plans, perms = [], [], []
    for d in range(ranks):
        _, k_proc = jax.random.split(jax.random.fold_in(key, d))
        part = shard(traj, d, local)
        if carry_boards is None:
            boards, actions, spawns = injected_exact(part, local, jcfg["scan_cap"])
            draws.append(dict(boards=boards.numpy(), actions=actions.numpy(),
                              spawns=spawns.numpy()))
        else:
            actions, spawns, resets = injected_packed(
                part, carry_boards[d * local:(d + 1) * local])
            draws.append(dict(actions=actions.numpy(), spawns=spawns.numpy(),
                              resets=resets.numpy()))
        plan, perm = jax_process_draws(JLOOP.TrainConfig(**jcfg), k_proc,
                                       jnp.asarray(part.valid.reshape(-1)))
        plans.append(tuple(x.numpy() for x in plan))
        perms.append(perm.numpy())
    return draws, plans, perms


def jax_exact_case(cfg: dict) -> tuple:
    params, labels, step, sd = jax_setup(cfg)
    key = jax.random.key(5)
    p, _, m, traj, out = step(params, jopt.init(params, labels), JA.RtgMoments.initial(),
                              key, jnp.int32(TRAIN_STEP + 1), jnp.float32(0.02))
    traj = jax.tree.map(np.asarray, traj)
    draws, plans, perms = rank_draws(cfg, key, traj, 8)
    job = dict(cfg=cfg, state_dict=sd, train_step=TRAIN_STEP, beta=0.02, draws=draws,
               plans=plans, perms=perms)
    return job, (p, m, out, traj)


def jax_packed_case() -> tuple:
    params, labels, step, sd = jax_setup(PACKED_D2)
    carry = jinit_carry(jmake_mesh(2), jax.random.key(11), 2 * LANES)
    boards = np.asarray(carry.boards).copy()
    near = np.zeros(2 * LANES, bool)
    near[[0, 1, LANES, LANES + 1]] = True  # two lanes of each shard end in step 1
    boards[near] = NEAR_END
    ep_moves = np.where(near, 300, 0).astype(np.int32)
    ep_points = np.where(near, 5000, 0).astype(np.int32)
    carry = carry._replace(boards=jnp.asarray(boards), ep_points=jnp.asarray(ep_points),
                           ep_moves=jnp.asarray(ep_moves))
    key = jax.random.key(6)
    p, _, m, carry1, traj, out = step(params, jopt.init(params, labels),
                                      JA.RtgMoments.initial(), carry, key,
                                      jnp.int32(TRAIN_STEP + 1), jnp.float32(0.02))
    traj = jax.tree.map(np.asarray, traj)
    draws, plans, perms = rank_draws(PACKED_D2, key, traj, LANES,
                                     carry_boards=np.asarray(carry1.boards))
    carries = [(boards[sl], ep_points[sl], ep_moves[sl])
               for sl in (slice(0, LANES), slice(LANES, 2 * LANES))]
    job = dict(cfg=PACKED_D2, state_dict=sd, train_step=TRAIN_STEP, beta=0.02, draws=draws,
               plans=plans, perms=perms, carries=carries)
    return job, (p, m, out, traj)


@pytest.fixture(scope="module")
def d2(tmp_path_factory):
    """The D=2 jobs, in one spawn of two ranks."""
    tmp = tmp_path_factory.mktemp("d2")
    src = tmp / "teacher"
    cli.main(["train", "--episodes", "4", "--batch-size", "16", "--scan-cap", "40", "-H", "16",
              "--num-layers", "1", "--steps", "1", "--warmup-steps", "0", "--points", "0.1",
              "--mono", "1.0", "--device", "cpu", "--checkpoint-dir", str(src)])
    exact_job, exact_ref = jax_exact_case(EXACT_D2)
    anchored_job, anchored_ref = jax_exact_case(ANCHORED_D2)
    packed_job, packed_ref = jax_packed_case()
    jobs = [("exact", "replay", exact_job), ("anchored", "replay", anchored_job),
            ("packed", "replay", packed_job),
            ("critic", "critic", dict(cfg=EXACT_D4, critics=(0.2, 5.0))),
            ("live", "expert", dict(cfg=EXPERT_D2)),
            ("frozen", "expert", dict(cfg=EXPERT_D2, expert_src=str(src)))]
    ranks = spawn_ranks(2, jobs, tmp)
    return dict(exact=exact_ref, anchored=anchored_ref, packed=packed_ref), ranks


@pytest.mark.parametrize("mode", ["exact", "packed", "anchored"])
def test_d2_ranks_replay_the_sharded_jax_step(d2, mode):
    """The KL diagnostic is on (kl_total and kl_average summed over the
    ranks, kl_max maxed); "anchored" adds --anchor-kl 0.5, whose KL term
    each rank normalises by the global weight sum."""
    refs, ranks = d2
    jparams, jmoments, jout, jtraj = refs[mode]
    want = dict(zip(JLOOP.SCALAR_KEYS, np.asarray(jout["scalars"]).tolist()))
    local = LANES if mode == "packed" else 8
    for r, res in enumerate(ranks):
        got = res[mode]["scalars"]
        for k in TLOOP.SCALAR_KEYS:
            if k in EXACT:
                assert got[k] == want[k], (r, k)
            elif k.startswith("kl_"):
                np.testing.assert_allclose(got[k], want[k], rtol=KL_RTOL, atol=0, err_msg=k)
            elif k in LOSS_STATS:
                np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=0, err_msg=k)
            else:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           atol=1e-5 * max(abs(want[k]), 1.0), err_msg=k)
        for g, w in zip(res[mode]["moments"], jmoments):
            np.testing.assert_allclose(g, float(w), rtol=1e-5)
        np.testing.assert_allclose(
            res[mode]["advantage"], np.asarray(jout["advantage"])[:, r * local:(r + 1) * local],
            rtol=1e-5, atol=1e-5)
        for name, w in _flat(jparams).items():
            np.testing.assert_allclose(res[mode]["params"][name], w, rtol=0, atol=5e-4,
                                       err_msg=name)
        assert res[mode]["steps_executed"] == int(jtraj.steps_executed)
    for name, p in ranks[0][mode]["params"].items():
        np.testing.assert_array_equal(p, ranks[1][mode]["params"][name], err_msg=name)
    assert ranks[0][mode]["scalars"] == ranks[1][mode]["scalars"]
    assert want["augmented_samples"] > 0 and want["num_batches"] >= 2
    assert want["kl_total"] > 0 and want["kl_max"] > 0
    if mode == "anchored":  # the same rollout as "exact": only the anchor's term differs
        exact = dict(zip(JLOOP.SCALAR_KEYS, np.asarray(refs["exact"][2]["scalars"]).tolist()))
        assert want["samples"] == exact["samples"] and want["loss"] != exact["loss"]
        assert any(not np.allclose(ranks[0][mode]["params"][n], ranks[0]["exact"]["params"][n])
                   for n in ranks[0][mode]["params"])
    if mode == "packed":
        assert want["env_steps"] == 2 * LANES * HORIZON and want["batch_max_score"] >= 5000
    else:
        assert want["best_idx"] == int(np.argmax(jtraj.total_points))


def test_critic_strength_reaches_the_sharded_objective(d2):
    _, ranks = d2
    low, high = ranks[0]["critic"]
    assert any(not np.allclose(low[n], high[n]) for n in low)
    for n in low:  # and both ranks took the same steps
        np.testing.assert_array_equal(low[n], ranks[1]["critic"][0][n])


@pytest.mark.parametrize("teacher", ["live", "frozen"])
def test_expert_iteration_runs_sharded(d2, teacher):
    _, ranks = d2
    for res in ranks:
        out = res[teacher]
        assert all(np.isfinite(v) for v in out["scalars"].values())
        assert out["total_points"].max() > 0
        np.testing.assert_allclose(out["target_probs"].sum(-1)[out["target_probs"].sum(-1) > 0],
                                   1.0, atol=1e-5)
        for n, p in out["params"].items():
            np.testing.assert_array_equal(p, ranks[0][teacher]["params"][n])
    assert ranks[0]["frozen"]["scalars"]["samples"] == ranks[1]["frozen"]["scalars"]["samples"]


def test_frozen_teacher_is_the_loaded_one(d2):
    """Each rank's sharded rollout equals its rollout with the teacher loaded
    from --expert-src, and differs from one the live policy teaches."""
    _, ranks = d2
    for res in ranks:
        out = res["frozen"]
        np.testing.assert_array_equal(out["target_probs"], out["frozen"])
        assert not np.allclose(out["target_probs"], out["live"])


@pytest.fixture(scope="module")
def d4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("d4")
    model = GameMLP(MLPConfig(hidden_dim=32, num_layers=2, dropout=0.0), zero_heads=False,
                    generator=torch.Generator().manual_seed(5)).eval()
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    x = torch.randn(16, 48, generator=torch.Generator().manual_seed(1)).numpy()
    jobs = [("exact", "global_stats", dict(cfg=EXACT_D4, steps=1)),
            ("packed", "global_stats", dict(cfg=PACKED_D4, steps=2)),
            ("meshes", "meshes", {}),
            ("tp", "tensor_parallel", dict(cfg=dict(BASE), state_dict=sd, inputs=x))]
    return model, x, spawn_ranks(4, jobs, tmp)


def _joined(ranks, mode, step, name):
    return torch.as_tensor(np.concatenate([r[mode][step][name] for r in ranks], axis=-1))


@pytest.mark.parametrize("mode", ["exact", "packed"])
def test_d4_moments_and_statistics_are_global(d4, mode):
    _, _, ranks = d4
    cfg = TLOOP.TrainConfig(**(EXACT_D4 if mode == "exact" else PACKED_D4), device="cpu")
    for step in range(1 if mode == "exact" else 2):
        first = ranks[0][mode][step]
        sc = first["scalars"]
        for r in ranks[1:]:
            assert r[mode][step]["scalars"] == sc and r[mode][step]["moments"] == first["moments"]
        fields = [_joined(ranks, mode, step, k) for k in torch_ranks._TRAJ_FIELDS]
        moments = TA.RtgMoments(*(torch.tensor(v) for v in first["moments_in"]))
        ts = TRAIN_STEP + step + 1
        if mode == "packed":
            boot = torch.as_tensor(np.concatenate([r[mode][step]["boot_value"] for r in ranks]))
            host = TA.compute_packed(*fields, _joined(ranks, mode, step, "done_here"), boot,
                                     cfg.reward_weights, cfg.gamma, moments, cfg.rtg_beta, ts)
            assert sc["env_steps"] == cfg.packed_lanes * cfg.horizon
        else:
            host = TA.compute(*fields, cfg.reward_weights, cfg.gamma, moments, cfg.rtg_beta, ts)
            scores = np.concatenate([r[mode][step]["total_points"] for r in ranks])
            assert 0 <= sc["best_idx"] < cfg.num_episodes == len(scores)
            assert scores[int(sc["best_idx"])] == scores.max() == sc["batch_max_score"]
        for g, w in zip(first["moments"], host["new_moments"]):
            np.testing.assert_allclose(g, float(w), rtol=1e-5)
        assert sc["samples"] == sc["env_steps"] == float(fields[-1].sum())
        assert sc["augmented_samples"] > 0 and sc["num_batches"] >= 2
        assert all(np.isfinite(v) for v in sc.values())


def test_d4_packed_lanes_continue_across_steps(d4):
    _, _, ranks = d4
    for r in ranks:
        one, two = r["packed"]
        np.testing.assert_array_equal(two["board_before"][0],
                                      one["carry_boards"].astype(np.int8))
        done_last = one["done_here"][-1]
        assert (one["carry_moves"][done_last] == 0).all() and one["carry_moves"].max() > 0
    first = [r["packed"][0]["board_before"][0] for r in ranks]
    assert not np.array_equal(first[0], first[1])  # each rank its own lanes


def test_make_mesh_shapes(d4):
    _, _, ranks = d4
    for r in ranks:
        assert r["meshes"] == {"1": ((4, 1), ("data", "model")),
                               "2": ((2, 2), ("data", "model"))}
    with pytest.raises(ValueError, match="not divisible by model axis 4"):
        TM.make_mesh(6, model_axis=4)


def test_tensor_parallel_forward_matches_single_rank(d4):
    model, x, ranks = d4
    with torch.no_grad():
        logits, value = model(torch.as_tensor(x))
    for r in ranks:
        np.testing.assert_allclose(r["tp"]["logits"], logits.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["tp"]["value"], value.numpy(), rtol=1e-5, atol=1e-5)
        local = r["tp"]["local"]
        assert local["blocks.0.lin.w"] == (16, 32) and local["stem.ln.g"] == (16,)
        assert local["action_head.w"] == (4, 16) and local["action_head.b"] == (4,)


def test_window_weights_add_up_to_the_rows():
    """The host's per-minibatch weight counts (the global denominators) are
    what the learner's windows weight, an exhausted shard's windows zero."""
    for s_cap, bs in ((50, 16), (50, 50), (10, 16), (97, 24)):
        for s in range(s_cap + 1):
            nb = -(-s // bs)
            counts = [TU.window_weight(s, s_cap, bs, mb) for mb in range(nb + 2)]
            for mb, c in enumerate(counts):
                start = min(mb * bs, max(s_cap - bs, 0))
                idx = np.arange(start, min(start + bs, s_cap))
                assert c == int(((idx >= mb * bs) & (idx < s)).sum()), (s_cap, bs, s, mb)
            assert sum(counts[:nb]) == s and counts[nb:] == [0, 0]


def test_single_rank_group_collectives_are_identities():
    g = TM.DataGroup()
    x = torch.arange(6.0).reshape(3, 2)
    assert g.sum(x) is x and g.max(x) is x and g.min(x) is x and g.gather(x) is x
    assert g.broadcast_object({"a": 1}, 0) == {"a": 1} and g.stats["calls"] == 0
    a, b = torch.tensor(3), torch.tensor(2.5)
    assert TM.all_sum(None, a, b) == (a, b) and TM.all_sum(g, a, b) == (a, b)
    assert TM.all_extrema(None, (a,), (b,)) == ((a,), (b,))
    assert TLOOP.rank_words(None) == () == TLOOP.rank_words(g)


def test_indivisible_shards_raise_the_jax_message():
    cfg = TLOOP.TrainConfig(**EXACT_D2, device="cpu")
    with pytest.raises(ValueError) as port:
        TLOOP.shard_sizes(cfg, 3)
    params, labels, _, _ = jax_setup(EXACT_D2)
    with pytest.raises(ValueError) as ref:
        make_sharded_train_step(jmake_mesh(3), JLOOP.TrainConfig(**EXACT_D2), None, None,
                                labels, jopt.OptimizerConfig())
    assert str(port.value) == str(ref.value)


def test_d1_group_equals_the_single_device_trainer(tmp_path):
    """A process group of one rank (Gloo, in this process) trains exactly as
    the trainer without one: the packed recipe with capture, 3 steps."""
    flags = ["--packed", "--lanes", "8", "--horizon", "6", "--batch-size", "16",
             "-H", "16", "--num-layers", "2", "--points", "0.1", "--mono", "1.0",
             "--upsample-ratio", "0.25", "--warmup-steps", "1", "--steps", "3",
             "--scan-cap", "200", "--print-freq", "100", "--eval-freq", "2",
             "--eval-games", "4", "--device", "cpu"]
    single = cli.train_config(flags + ["--checkpoint-dir", str(tmp_path / "a")])
    TLOOP.train(single)
    group = TM.init_distributed(f"file://{tmp_path}/rendezvous", rank=0, world_size=1,
                                device="cpu")
    try:
        TLOOP.train(cli.train_config(flags + ["--checkpoint-dir", str(tmp_path / "b")]),
                    group=group)
    finally:
        TM.shutdown()
    for name in ("train_state", "env_carry", "best_model"):
        with np.load(tmp_path / "a" / f"{name}.npz") as a, \
                np.load(tmp_path / "b" / f"{name}.npz") as b:
            assert set(a.files) == set(b.files)
            for k in a.files:
                if k == "__manifest__":
                    ma, mb = json.loads(str(a[k])), json.loads(str(b[k]))
                    ma.get("config", {}).pop("checkpoint_dir", None)
                    mb.get("config", {}).pop("checkpoint_dir", None)
                    assert ma == mb, name
                else:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} {k}")
