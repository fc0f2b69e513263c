"""The single-device PPO trainer as a whole (tpu2048_torch/train/{loop,cli}.py).

* One train step against the JAX package's rollout + ``process`` on the
  same parameters, augmentation plan and shuffle: a packed chunk, and an
  exact-episodes rollout (its draws replayed). Tolerances: parameters 5e-4
  absolute (bfloat16 Newton-Schulz, as in tests/test_torch_update.py),
  moments and the advantage statistics 1e-5 relative, loss statistics 2e-4
  relative, the counts (samples, scores, tiles, best lane, env steps,
  minibatches) exact.
* A 4-step CPU run equals 2 steps + --resume + 2 steps bit for bit: the
  packed MLP without capture, and each non-expert recipe of scripts/ at a
  small size (expG packed with capture, the URM's packed recipe, expA2's
  exact episodes), which also print breakdowns and write viz JSON.
* The port's train_state/env_carry pairs have the JAX-written pairs' leaves,
  shapes and dtypes, and the JAX package's loaders read them (the MLP and
  the URM, the recorder's episode included); the committed JAX-written
  checkpoints (urm_r5, expG, expA) read by the port and written back are
  equal leaf for leaf.
* Full width on the CPU: a copy of checkpoints_expG resumes at step 20000
  on its 512 carried boards and writes its step-20000 checkpoint.
* Unported flags raise NotImplementedError (expert iteration and the
  anchor are ported: tests/test_torch_expert_train.py), data-parallel
  layouts that cannot run raise (tests/test_torch_parallel.py holds the
  data-parallel trainer); asking for cuda without a card raises."""

import contextlib
import io
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_engine import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_optim import _flat
from tests.test_torch_rollout_exact import injected as injected_exact
from tests.test_torch_rollout_exact import jax_rollout
from tests.test_torch_rollout_exact import port_model
from tests.test_torch_rollout_packed import HORIZON, LANES, injected, jax_chunks
from tpu2048.algo import advantage as JA
from tpu2048.algo import augment as JAUG
from tpu2048.algo import capture as JC
from tpu2048.algo import rollout as JR
from tpu2048.algo import update as JU
from tpu2048.models import MLPConfig as JMLPConfig
from tpu2048.models import URMConfig as JURMConfig
from tpu2048.models import mlp as jmlp
from tpu2048.models import urm as jurm
from tpu2048.ops import optimizer as jopt
from tpu2048.train import checkpoint as JCKPT
from tpu2048.train import loop as JLOOP
from tpu2048.train.evaluate import load_model_checkpoint as jload_model
from tpu2048_torch.algo import advantage as TA
from tpu2048_torch.algo import augment as TAUG
from tpu2048_torch.algo import capture as TC
from tpu2048_torch.algo import rollout as TR
from tpu2048_torch.algo import update as TU
from tpu2048_torch.models.mlp import param_labels
from tpu2048_torch.ops import optimizer as topt
from tpu2048_torch.train import cli
from tpu2048_torch.train import loop as TLOOP
from tpu2048_torch.train.checkpoint import key_path
from tpu2048_torch.utils.logger import MetricLogger

ROOT = Path(__file__).resolve().parent.parent
RECIPE = dict(packed=True, lanes=LANES, horizon=HORIZON, batch_size=48, hidden_size=32,
              num_layers=2, dropout=0.0, upsample_ratio=0.25, points_weight=0.1,
              monotonicity_weight=1.0, gamma=0.995, rtg_beta=0.99, warmup_steps=0,
              steps=10, kl_diagnostic=False, learning_rate=1e-3, critic_lr=3e-4,
              entropy_strength=0.02, critic_strength=0.2)
EXACT = ("samples", "augmented_samples", "batch_max_score", "batch_avg_score",
         "avg_score", "median_score", "pct_512", "pct_1024", "pct_2048", "best_idx",
         "env_steps", "num_batches", "sched_mult", "zero_reward_pct")
LOSS_STATS = ("loss", "policy_loss", "entropy_loss", "value_loss", "grad_norm",
              "entropy", "kl_total", "kl_average", "kl_max")


def test_scalar_keys_are_the_references():
    assert TLOOP.SCALAR_KEYS == JLOOP.SCALAR_KEYS
    assert TLOOP.EVAL_KEYS == JLOOP.EVAL_KEYS
    port = set(TLOOP.TrainConfig.__dataclass_fields__) - {"device"}
    assert port == set(JLOOP.TrainConfig.__dataclass_fields__)
    for name in port:
        assert getattr(TLOOP.TrainConfig(), name) == getattr(JLOOP.TrainConfig(), name), name


def jax_process_draws(jcfg, k_proc, flat_valid):
    """The draws the JAX process takes from ``k_proc``: the augmentation
    plan, then the first epoch's shuffle, as the port takes them."""
    k_aug, k_rest = jax.random.split(k_proc)
    k_opt, _ = jax.random.split(k_rest)
    s_real = flat_valid.shape[0]
    num_slots = int(np.ceil(s_real * jcfg.upsample_ratio))
    jplan = JAUG.plan(k_aug, num_slots, jnp.minimum(
        (jnp.sum(flat_valid).astype(jnp.float32) * jcfg.upsample_ratio).astype(jnp.int32),
        num_slots), flat_valid)
    k_perm = jax.random.split(k_opt, 3)[0]
    perm = np.asarray(jax.random.uniform(k_perm, (s_real + 2 * num_slots,)))[None]
    plan = TAUG.AugPlan(*(torch.tensor(np.asarray(x)).long() for x in jplan[:2]),
                        torch.tensor(np.asarray(jplan.valid)))
    return plan, torch.tensor(perm)


def jax_step(jcfg, mcfg, params, jtraj):
    """The JAX package's process of ``jtraj`` at step 1: (params, moments,
    outputs, the port's plan and shuffle draws)."""
    labels = jmlp.param_labels(params)
    apply_train = lambda p, x, rng: jmlp.apply(p, mcfg, x, train=True, rng=rng)  # noqa: E731
    ocfg = jopt.OptimizerConfig(learning_rate=1e-3, critic_lr=3e-4)
    jprocess = JLOOP.make_process_fn(jcfg, apply_train, labels, JU.make_optimize_fn(
        apply_train, labels, ocfg, jcfg.batch_size, jcfg.ppo_epochs, kl_diagnostic=False))
    k_proc = jax.random.key(7)
    jparams, _, jmoments, jout = jprocess(params, jopt.init(params), jtraj,
                                          JA.RtgMoments.initial(), k_proc, jnp.int32(1),
                                          jnp.float32(0.02))
    plan, perm = jax_process_draws(jcfg, k_proc, jtraj.valid.reshape(-1))
    return jparams, jmoments, jout, plan, perm


def port_step(tcfg, params, mcfg, ttraj, plan, perm):
    """The port's process of ``ttraj`` at step 1 on a model holding
    ``params``: (model, moments, outputs)."""
    model = port_model(params, mcfg)
    state = topt.init(dict(model.named_parameters()))
    tprocess = TLOOP.make_process_fn(tcfg, TU.make_optimize_fn(
        model, param_labels(model), topt.OptimizerConfig(learning_rate=1e-3, critic_lr=3e-4),
        tcfg.batch_size, tcfg.ppo_epochs, kl_diagnostic=False))
    tmoments, tout = tprocess(state, ttraj, TA.RtgMoments.initial(), 1, 0.02, aug_plan=plan,
                              perm_draws=perm)
    return model, tmoments, tout


def assert_step_matches(model, tmoments, tout, jparams, jmoments, jout) -> dict:
    got = dict(zip(TLOOP.SCALAR_KEYS, tout["scalars"].tolist()))
    want = dict(zip(JLOOP.SCALAR_KEYS, np.asarray(jout["scalars"]).tolist()))
    for k in TLOOP.SCALAR_KEYS:
        if k in EXACT:
            assert got[k] == want[k], k
        elif k in LOSS_STATS:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=0, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-5 * max(abs(want[k]), 1.0), err_msg=k)
    for g, w in zip(tmoments, jmoments):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
    np.testing.assert_allclose(tout["advantage"].numpy(), np.asarray(jout["advantage"]),
                               rtol=1e-5, atol=1e-5)
    got_p = {n: p.detach().numpy() for n, p in model.named_parameters()}
    for name, w in _flat(jparams).items():
        np.testing.assert_allclose(got_p[name], w, rtol=0, atol=5e-4, err_msg=name)
    return got


def test_one_train_step_matches_jax():
    jcfg = JLOOP.TrainConfig(**RECIPE)
    mcfg = JMLPConfig(hidden_dim=32, num_layers=2, dropout=0.0)
    params = jmlp.init(jax.random.key(3), mcfg, zero_heads=False)
    _, chunks = jax_chunks(mcfg, params)
    jtraj_np, jcarry = chunks[0]
    jtraj = JR.PackedTrajectory(**{k: jnp.asarray(v) for k, v in jtraj_np._asdict().items()})
    jparams, jmoments, jout, plan, perm = jax_step(jcfg, mcfg, params, jtraj)

    near_end = np.arange(LANES) < 4  # as jax_chunks made them
    carry = TR.EnvCarry(torch.tensor(jtraj_np.board_before[0].astype(np.int32)),
                        np.zeros(2, np.uint32),
                        torch.tensor(np.where(near_end, 5000, 0), dtype=torch.int32),
                        torch.tensor(np.where(near_end, 300, 0), dtype=torch.int32))
    actions, spawns, resets = injected(jtraj_np, jcarry.boards)
    ttraj, _ = TR.rollout_packed(port_model(params, mcfg), carry, HORIZON, actions=actions,
                                 spawns=spawns, resets=resets)
    model, tmoments, tout = port_step(TLOOP.TrainConfig(**RECIPE, device="cpu"), params, mcfg,
                                      ttraj, plan, perm)
    got = assert_step_matches(model, tmoments, tout, jparams, jmoments, jout)
    assert got["num_batches"] >= 4 and got["env_steps"] == LANES * HORIZON
    assert got["batch_max_score"] >= 5000 and got["augmented_samples"] > 0


EXACT_RECIPE = dict(RECIPE, packed=False, num_episodes=8, scan_cap=100)


def test_one_exact_step_matches_jax():
    """Exact-episodes mode: a JAX rollout of 8 games (cap 100, some cut)
    replayed by the port's rollout, then one process each: (100, 8)
    records, so S = 800 rows and 200 augmentation slots."""
    jcfg = JLOOP.TrainConfig(**EXACT_RECIPE)
    mcfg = JMLPConfig(hidden_dim=32, num_layers=2, dropout=0.0)
    params = jmlp.init(jax.random.key(3), mcfg, zero_heads=False)
    jtraj_np = jax_rollout(params, mcfg, 8, 100, seed=9)
    jtraj = JR.Trajectory(**{k: jnp.asarray(v) for k, v in jtraj_np._asdict().items()})
    jparams, jmoments, jout, plan, perm = jax_step(jcfg, mcfg, params, jtraj)
    boards, actions, spawns = injected_exact(jtraj_np, 8, 100)
    ttraj = TR.rollout(port_model(params, mcfg), 8, 100, boards=boards, actions=actions,
                       spawns=spawns)
    model, tmoments, tout = port_step(TLOOP.TrainConfig(**EXACT_RECIPE, device="cpu"), params,
                                      mcfg, ttraj, plan, perm)
    got = assert_step_matches(model, tmoments, tout, jparams, jmoments, jout)
    assert got["env_steps"] == int(jtraj_np.num_moves.sum()) < 800
    assert got["best_idx"] == int(np.argmax(jtraj_np.total_points)) and got["num_batches"] > 4


TINY = ["train", "--packed", "--lanes", "8", "--horizon", "6", "--batch-size", "16",
        "-H", "16", "--num-layers", "2", "--no-packed-capture", "--device", "cpu",
        "--points", "0.1", "--mono", "1.0", "--upsample-ratio", "0.25",
        "--warmup-steps", "1", "--adaptive-beta", "--eval-freq", "2", "--eval-games", "4",
        "--scan-cap", "200", "--dropout", "0.1", "--print-freq", "100"]


def _run(ckpt, logs, steps, *extra):
    cli.main(TINY + ["--steps", str(steps), "--checkpoint-dir", str(ckpt), "--log-dir",
                     str(logs), *extra])


def _npz(path):
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def _log_lines(d):
    (f,) = Path(d).glob("*.jsonl")
    out = {}
    for line in f.read_text().splitlines():
        entry = json.loads(line)
        entry.pop("timestamp")
        out.setdefault(entry["step"], []).append(entry)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("train")
    _run(base / "a", base / "la", 4)
    _run(base / "b", base / "lb1", 2)
    _run(base / "b", base / "lb2", 4, "--resume")
    return base


def test_resumed_run_is_bit_identical(runs):
    for name in ("train_state", "env_carry", "best_model"):
        a, b = _npz(runs / "a" / f"{name}.npz"), _npz(runs / "b" / f"{name}.npz")
        assert set(a) == set(b), name
        ma, mb = json.loads(str(a.pop("__manifest__"))), json.loads(str(b.pop("__manifest__")))
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} {k}")
        for m in (ma, mb):
            for k in ("resume", "log_dir", "checkpoint_dir"):
                m.get("config", {}).pop(k, None)
        assert ma == mb, name
    ta = _npz(runs / "a" / "train_state.npz")
    assert ta["['opt_state'].adamw.step"] > 4  # several minibatches a step
    la, lb = _log_lines(runs / "la"), _log_lines(runs / "lb2")
    assert sorted(lb) == [2, 3] and la[2] == lb[2] and la[3] == lb[3]
    assert len(la[2]) == 2 and "eval/avg_score" in la[2][1]  # step 2 evaluated


def test_logged_metrics_are_the_references(runs):
    from tpu2048.utils import stats as jstats

    la = _log_lines(runs / "la")
    sc = {k: 1.0 for k in JLOOP.SCALAR_KEYS}
    want = list(jstats.assemble_metrics(
        sc, sc, highest_score=0, ema_avg_score=0, ema_pct_512=0, ema_pct_1024=0,
        ema_pct_2048=0, batch_pct_512=0, batch_pct_1024=0, batch_pct_2048=0,
        ema_explained_var=0, current_beta=0, lr=0))
    assert list(la[0][0])[1:] == want  # after "step", in the reference's order
    assert all(np.isfinite(v) for v in la[3][0].values() if isinstance(v, float))


def test_checkpoint_pair_matches_a_jax_written_pair(runs, tmp_path):
    """The leaves, shapes and dtypes of what the JAX package writes for the
    same config (its train-state tree and ``save_env_carry`` without a
    recorder), and its loaders read the port's files."""
    mcfg = JMLPConfig(hidden_dim=16, num_layers=2, dropout=0.1)
    params = jmlp.init(jax.random.key(0), mcfg)
    tree = dict(params=params, opt_state=jopt.init(params), moments=JA.RtgMoments.initial(),
                key=jax.random.key_data(jax.random.key(0)))
    JCKPT.save_checkpoint(tmp_path, "train_state", arrays_tree=tree, manifest={})
    JLOOP.save_env_carry(tmp_path, JR.init_env_carry(jax.random.key(1), 8), None, 3, 8, 1)
    for name in ("train_state", "env_carry"):
        want, got = _npz(tmp_path / f"{name}.npz"), _npz(runs / "a" / f"{name}.npz")
        assert {k: (v.shape, v.dtype) for k, v in got.items() if k != "__manifest__"} == \
               {k: (v.shape, v.dtype) for k, v in want.items() if k != "__manifest__"}, name
        jm = json.loads(str(want["__manifest__"]))
        tm = json.loads(str(got["__manifest__"]))
        if name == "env_carry":
            assert tm == dict(jm, train_step=3, has_recorder=False)
    loaded, manifest = JCKPT.load_checkpoint(runs / "a", "train_state", tree)
    assert manifest["train_step"] == 3 and int(loaded["opt_state"].adamw.step) > 4
    jcarry, best = JLOOP.load_env_carry(str(runs / "a"), 8, 200)
    assert best is None
    np.testing.assert_array_equal(np.asarray(jcarry.boards),
                                  _npz(runs / "a" / "env_carry.npz")["['boards']"])
    for ckpt in ("best_model", "train_state"):
        d = tmp_path / ckpt
        d.mkdir()
        for f in (runs / "a").glob(f"{ckpt}.*"):
            shutil.copy(f, d)
        jparams, jmc, jmt = jload_model(d)
        assert jmt == "mlp" and (jmc.hidden_dim, jmc.num_layers) == (16, 2)


def test_resumes_checkpoints_expG_at_full_width(tmp_path, capsys):
    """The expG recipe on the CPU at 512 lanes, horizon 2, from a copy of the
    committed step-19,999 state (never written to)."""
    src = ROOT / "checkpoints_expG"
    for f in src.glob("train_state.*"):
        shutil.copy(f, tmp_path)
    for f in src.glob("env_carry.*"):
        shutil.copy(f, tmp_path)
    carried = _npz(tmp_path / "env_carry.npz")["['boards']"]
    cli.main(["train", "--packed", "--lanes", "512", "--horizon", "2", "--batch-size", "4096",
              "--lr", "1e-3", "--critic-lr", "1e-4", "-H", "384", "--num-layers", "3",
              "--gamma", "0.995", "--dropout", "0.0", "--entropy", "0.02", "--adaptive-beta",
              "--target-entropy", "0.25", "--beta-min", "0.001", "--beta-max", "0.05",
              "--beta-lr", "0.005", "--points", "0.10", "--mono", "1.0", "--critic", "0.2",
              "--rtg-beta", "0.99", "--warmup-steps", "20", "--upsample-ratio", "0.25",
              "-t", "mlp", "--no-kl-diagnostic", "--no-packed-capture", "--steps", "20001",
              "--checkpoint-dir", str(tmp_path), "--resume", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Resumed from step 20000" in out and "Resumed packed env carry" in out
    assert "Trained 1 steps, 1024 env steps" in out
    state = json.loads((tmp_path / "train_state.json").read_text())
    carry = json.loads((tmp_path / "env_carry.json").read_text())
    assert state["train_step"] == carry["train_step"] == 20000
    assert carry["has_recorder"] is False and carry["lanes"] == 512
    # Two moves from the carried boards: a lane's tile sum grows by the two
    # spawned tiles (2 or 4 each; merges keep the sum), unless its game ended.
    after = _npz(tmp_path / "env_carry.npz")["['boards']"]

    def tile_sum(b):
        return np.where(b > 0, 2 ** b.astype(np.int64), 0).sum((1, 2))

    grew = tile_sum(after) - tile_sum(carried)
    assert np.isin(grew, (4, 6, 8)).mean() > 0.95
    assert (src / "train_state.json").read_text().count('"train_step": 19999') == 1


@pytest.mark.parametrize("flags,error,named", [
    (["--packed", "--no-packed-capture", "--lanes", "6", "--batch-size", "8",
      "--mesh-data", "4"], ValueError,
     "lanes=6 and batch_size=8 must be divisible by data axis size 4"),
    (["--episodes", "8", "--batch-size", "6", "--mesh-data", "4"], ValueError,
     "num_episodes=8 and batch_size=6 must be divisible by data axis size 4"),
    (["--packed", "--no-packed-capture", "--wandb"], NotImplementedError, "--wandb"),
    (["--packed", "--lanes", "6", "--batch-size", "6", "--mesh-data", "3",
      "--num-processes", "2", "--process-id", "0", "--coordinator-address", "127.0.0.1:9"],
     ValueError, "--mesh-data 3 is not divisible by --num-processes 2"),
    (["--packed", "--lanes", "4", "--batch-size", "4", "--mesh-data", "2", "--device", "cuda"],
     RuntimeError, "cuda"),
    (["--packed", "--no-packed-capture", "--platform", "cpu"], NotImplementedError,
     "--platform"),
])
def test_unported_flags_raise(flags, error, named, tmp_path):
    """The refusals: the unported flags, and the data-parallel layouts that
    cannot run (shards that do not divide, a CUDA run without a card)."""
    if "cuda" in flags and torch.cuda.is_available():
        pytest.skip("a card is present: this checks the CPU-only machine")
    with pytest.raises(error, match=named):
        cli.main(["train", "--steps", "1", "--checkpoint-dir", str(tmp_path),
                  "--device", "cpu", *flags])
    assert not any(tmp_path.iterdir())


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the CPU-only machine")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(TINY[:-4] + ["--steps", "1", "--checkpoint-dir", str(tmp_path),
                              "--device", "cuda"])
    assert not any(tmp_path.iterdir())


# --- Every non-expert recipe of scripts/ through the CLI, at a small size ---
# Each keeps its script's flags but for the sizes (lanes, horizon, episodes,
# widths, batch, scan cap), the directories, --print-freq 1 and
# --show-last-steps 2.
RECIPES = {
    "expG_packed": ["--packed", "--lanes", "8", "--horizon", "48", "--batch-size", "64",
                    "--lr", "1e-3", "--critic-lr", "1e-4", "-H", "16", "--num-layers", "3",
                    "--gamma", "0.995", "--dropout", "0.0", "--entropy", "0.02",
                    "--adaptive-beta", "--target-entropy", "0.25", "--beta-min", "0.001",
                    "--beta-max", "0.05", "--beta-lr", "0.005", "--points", "0.10", "--mono",
                    "1.0", "--critic", "0.2", "--rtg-beta", "0.99", "--warmup-steps", "1",
                    "--upsample-ratio", "0.25", "-t", "mlp", "--no-kl-diagnostic",
                    "--eval-freq", "3", "--eval-games", "4", "--checkpoint-freq", "3",
                    "--scan-cap", "96"],
    "urm_long": ["--packed", "--lanes", "8", "--horizon", "48", "--batch-size", "64",
                 "-t", "urm", "-H", "16", "--num-layers", "2", "--num-heads", "4",
                 "--num-loops", "4", "--truncated-loops", "1", "--lr", "1e-3",
                 "--critic-lr", "1e-4", "--gamma", "0.99", "--entropy", "0.02",
                 "--dropout", "0.0", "--points", "0.10", "--mono", "1.0", "--critic", "0.2",
                 "--rtg-beta", "0.99", "--warmup-steps", "1", "--upsample-ratio", "0.25",
                 "--no-kl-diagnostic", "--eval-freq", "3", "--eval-games", "4",
                 "--checkpoint-freq", "3", "--scan-cap", "96"],
    "expA2_exact": ["--episodes", "4", "--batch-size", "128", "--lr", "5e-4",
                    "--critic-lr", "3e-4", "-H", "16", "--gamma", "0.995", "--entropy",
                    "0.02", "--adaptive-beta", "--target-entropy", "0.25", "--beta-min",
                    "0.001", "--beta-max", "0.05", "--beta-lr", "0.005", "--points", "0.10",
                    "--mono", "1.0", "--critic", "0.2", "--rtg-beta", "0.99",
                    "--warmup-steps", "1", "--upsample-ratio", "0.25", "-t", "mlp",
                    "--no-kl-diagnostic", "--eval-freq", "3", "--eval-games", "4",
                    "--checkpoint-freq", "3", "--scan-cap", "160"],
}


def _recipe_run(flags, base, name, steps, *extra):
    cli.main(["train", *flags, "--steps", str(steps), "--checkpoint-dir", str(base / "ck"),
              "--log-dir", str(base / f"log_{name}"), "--viz-dir", str(base / "viz"),
              "--print-freq", "1", "--show-last-steps", "2", "--device", "cpu", *extra])


@pytest.fixture(scope="module", params=sorted(RECIPES))
def recipe_runs(request, tmp_path_factory):
    """4 steps straight (``a``), and 2 steps then --resume to 4 (``b``), with
    what each printed."""
    flags = RECIPES[request.param]
    base = tmp_path_factory.mktemp(request.param)
    out = {}
    for run, parts in (("a", [(4, ())]), ("b", [(2, ()), (4, ("--resume",))])):
        printed = []
        for steps, extra in parts:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                _recipe_run(flags, base / run, f"{steps}", steps, *extra)
            printed.append(buf.getvalue())
        out[run] = (base / run, printed)
    return request.param, out


def test_recipe_prints_breakdowns_and_writes_viz(recipe_runs):
    name, out = recipe_runs
    run_dir, (printed,) = out["a"]
    assert printed.count("Reward breakdown:") >= 2 and "PBRS Reward Shaping" in printed
    assert "Final state:" in printed and "Last 2 steps (pts:" in printed
    viz = sorted((run_dir / "viz").glob("step_*.json"))
    assert len(viz) >= 2
    data = json.loads(viz[-1].read_text())
    committed = json.loads((ROOT / "viz_data_expG" / "step_000000.json").read_text())
    assert list(data) == list(committed) and data["moves"]
    assert list(data["moves"][0]["rewards"]) == list(committed["moves"][0]["rewards"])
    (log,) = (run_dir / "log_4").glob("*.jsonl")
    assert "eval/avg_score" in log.read_text()
    state = json.loads((run_dir / "ck" / "train_state.json").read_text())
    assert state["config"]["model_type"] == ("urm" if name == "urm_long" else "mlp")
    assert (run_dir / "ck" / "best_model.npz").exists()


def test_recipe_resume_is_bit_identical(recipe_runs):
    """The resumed run trains exactly as the straight one; a packed run's
    env_carry keeps the lanes and the recorded best episode (lanes mid-
    episode at the resume are tainted, so the resumed recorder may commit
    less)."""
    name, out = recipe_runs
    (a_dir, _), (b_dir, (_, resumed)) = out["a"], out["b"]
    assert "Resumed from step 2" in resumed
    a, b = _npz(a_dir / "ck" / "train_state.npz"), _npz(b_dir / "ck" / "train_state.npz")
    assert set(a) == set(b)
    for k in a:
        if k != "__manifest__":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if name == "expA2_exact":
        assert not (b_dir / "ck" / "env_carry.npz").exists()
        return
    assert "Resumed packed env carry" in resumed
    ca, cb = _npz(a_dir / "ck" / "env_carry.npz"), _npz(b_dir / "ck" / "env_carry.npz")
    assert json.loads(str(cb["__manifest__"]))["has_recorder"] is True
    for k in ("['boards']", "['ep_points']", "['ep_moves']"):
        np.testing.assert_array_equal(ca[k], cb[k], err_msg=k)
    assert 0 < int(cb["['best_score']"]) <= int(ca["['best_score']"])


def test_unported_flag_names_what_is_missing():
    """The replaced cases: -t urm, exact mode (no --packed), packed capture,
    --viz-dir and --show-last-steps all configure and pass check_ported."""
    cfg = cli.train_config(["-t", "urm", "--viz-dir", "v", "--show-last-steps", "3",
                            "--device", "cpu"])
    TLOOP.check_ported(cfg)
    assert (cfg.model_type, cfg.packed, cfg.packed_capture) == ("urm", False, True)
    TLOOP.check_ported(cli.train_config(["--packed", "--device", "cpu"]))
    with pytest.raises(ValueError, match="Unknown model type"):
        TLOOP.check_ported(cli.train_config(["-t", "cnn"]))


def _jax_model(model_config: dict, model_type: str):
    """(the JAX params tree, its labels) of a manifest's model."""
    if model_type == "urm":
        cfg = JURMConfig(**model_config)
        params = jurm.init(jax.random.key(0), cfg)
        return params, jurm.param_labels(params)
    params = jmlp.init(jax.random.key(0), JMLPConfig(**model_config))
    return params, jmlp.param_labels(params)


def test_port_checkpoints_read_in_jax(recipe_runs, tmp_path):
    """The train_state (MLP or URM) and env_carry (with the recorder's
    episode) the port wrote, read by the JAX package's loaders; their leaves,
    shapes and dtypes those the JAX package writes."""
    name, out = recipe_runs
    ck = out["a"][0] / "ck"
    manifest = json.loads((ck / "train_state.json").read_text())
    params, labels = _jax_model(manifest["model_config"], manifest["config"]["model_type"])
    tree = dict(params=params, opt_state=jopt.init(params, labels),
                moments=JA.RtgMoments.initial(), key=jax.random.key_data(jax.random.key(0)))
    loaded, m = JCKPT.load_checkpoint(ck, "train_state", tree)
    assert m["train_step"] == 3
    got = _npz(ck / "train_state.npz")
    for k, v in _flat(loaded["params"]).items():
        np.testing.assert_array_equal(v, got[f"['params']{key_path(k)}"], err_msg=k)
    JCKPT.save_checkpoint(tmp_path, "train_state", arrays_tree=tree, manifest={})
    want = _npz(tmp_path / "train_state.npz")
    assert {k: (v.shape, v.dtype) for k, v in got.items() if k != "__manifest__"} == \
           {k: (v.shape, v.dtype) for k, v in want.items() if k != "__manifest__"}
    if name == "expA2_exact":
        return
    cap = manifest["config"]["scan_cap"]
    carry, best = JLOOP.load_env_carry(str(ck), 8, cap)
    written = _npz(ck / "env_carry.npz")
    assert best is not None and int(best["best_score"]) > 0
    for k, v in best.items():
        np.testing.assert_array_equal(np.asarray(v), written[f"['{k}']"], err_msg=k)
    JLOOP.save_env_carry(tmp_path, JR.init_env_carry(jax.random.key(1), 8),
                         JC.init_recorder(8, cap), 3, 8, 1)
    want = _npz(tmp_path / "env_carry.npz")
    assert {k: (v.shape, v.dtype) for k, v in written.items() if k != "__manifest__"} == \
           {k: (v.shape, v.dtype) for k, v in want.items() if k != "__manifest__"}
    assert json.loads(str(written["__manifest__"])) == dict(
        json.loads(str(want["__manifest__"])), train_step=3)


@pytest.mark.parametrize("src", ["checkpoints_urm_r5", "checkpoints_expG", "checkpoints_expA"])
def test_committed_checkpoints_round_trip_through_the_port(src, tmp_path):
    """A JAX-written train_state (and env_carry with its recorded episode)
    read by the port and written back: every leaf equal."""
    d = ROOT / src
    manifest = json.loads((d / "train_state.json").read_text())
    fields = set(TLOOP.TrainConfig.__dataclass_fields__)
    cfg = TLOOP.TrainConfig(**{k: v for k, v in manifest["config"].items() if k in fields},
                            device="cpu")
    _, model, _ = TLOOP.build_model(cfg)
    opt_state, moments, key, m = TLOOP.load_train_state(d, model, "cpu")
    assert m["train_step"] == manifest["train_step"]
    want = _npz(d / "train_state.npz")
    got = TLOOP.train_state_leaves(model, opt_state, moments, key)
    assert set(got) == set(want) - {"__manifest__"}
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
        assert v.dtype == want[k].dtype, k
    if not cfg.packed:
        return
    carry, best = TLOOP.load_env_carry(d, cfg.packed_lanes, cfg.scan_cap, "cpu",
                                       MetricLogger())
    assert best is not None and int(best["best_len"]) > 0
    rec = TC.init_recorder(1, cfg.scan_cap)._replace(**best)
    TLOOP.save_env_carry(tmp_path, carry, rec, m["train_step"], cfg.packed_lanes)
    want, got = _npz(d / "env_carry.npz"), _npz(tmp_path / "env_carry.npz")
    assert set(got) == set(want)
    for k in want:
        if k != "__manifest__":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype, k
    assert json.loads(str(got["__manifest__"])) == json.loads(str(want["__manifest__"]))
