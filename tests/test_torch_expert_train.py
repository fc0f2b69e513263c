"""Expert iteration through the port's trainer (tpu2048_torch/train/{loop,cli}.py)
against tpu2048's.

* One exact expert train step (the expert rollout replayed, then
  ``process`` with the imitation-sharp objective) against the JAX step on
  the same parameters, augmentation plan and shuffle: a frozen bf16 teacher,
  and the live teacher with coefs from the moments and the anchor-KL trust
  region. Tolerances as tests/test_torch_train.py states them for a PPO
  step (parameters 5e-4 absolute, moments and advantage statistics 1e-5
  relative, loss statistics 2e-4 relative, counts exact); the rollout's
  records as tests/test_torch_expert.py states them.
* A tiny CLI run of ``--expert-iter --expert-src <tiny checkpoint>
  --anchor-kl 0.5`` (and of the live teacher): 4 steps equal the run cut
  and resumed, bit for bit on the CPU, and the JAX package reads the
  checkpoint it writes. ``--packed --expert-iter`` raises ``ValueError``.
* Full width on the CPU: the committed expF student (H=384x3, step 200)
  and its frozen teacher (checkpoints_expA, bf16 leaves) load through the
  trainer's own loaders, and a depth-1 expert rollout of the recipe's mix
  and temperature over 4 boards replays the JAX package's (depth 1 bounds
  the CPU time)."""

import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_engine import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_expert import INT_FIELDS, assert_replays
from tests.test_torch_optim import _flat
from tests.test_torch_rollout_exact import injected, port_model
from tests.test_torch_train import RECIPE, _npz, assert_step_matches, jax_process_draws
from tpu2048.algo import advantage as JA
from tpu2048.algo import rollout as JR
from tpu2048.algo import search as JS
from tpu2048.algo import update as JU
from tpu2048.models import MLPConfig as JMLPConfig
from tpu2048.models import mlp as jmlp
from tpu2048.ops import optimizer as jopt
from tpu2048.train import checkpoint as JCKPT
from tpu2048.train import loop as JLOOP
from tpu2048.train.evaluate import load_model_checkpoint as jload_model
from tpu2048.train.evaluate import load_search_coefs as jload_coefs
from tpu2048_torch.algo import advantage as TA
from tpu2048_torch.algo import rollout as TR
from tpu2048_torch.algo import search as TS
from tpu2048_torch.algo import update as TU
from tpu2048_torch.models.mlp import param_labels
from tpu2048_torch.ops import optimizer as topt
from tpu2048_torch.train import cli
from tpu2048_torch.train import loop as TLOOP
from tpu2048_torch.train.checkpoint import key_path

ROOT = Path(__file__).resolve().parent.parent
GAMES, CAP = 4, 30
EXPERT_RECIPE = dict(RECIPE, packed=False, num_episodes=GAMES, scan_cap=CAP, rtg_beta=0.9,
                     expert_iter=True, expert_depth=1, expert_mix=0.5, expert_tau=0.02,
                     expert_sharp=True)
STUDENT = JMLPConfig(hidden_dim=32, num_layers=2, dropout=0.0)
TEACHER = JMLPConfig(hidden_dim=24, num_layers=1)
TEACHER_COEFS = dict(points=0.1, mono=1.0, empt=0.0, sigma=2.5, mu=-0.4, gamma=0.995)
# mu, m2 of the live moments: at step 1 (bias correction 0.1 at rtg_beta
# 0.9) mu 30 and sigma sqrt(1300 - 30^2) = 20.
MOMENTS = (3.0, 130.0)


def jax_moments():
    mu, m2 = (jnp.float32(v) for v in MOMENTS)
    return JA.RtgMoments(mu, m2, mu)


def port_moments():
    mu, m2 = (torch.tensor(v, dtype=torch.float32) for v in MOMENTS)
    return TA.RtgMoments(mu, m2, mu)


@pytest.mark.parametrize("frozen", [True, False], ids=["frozen_bf16", "live_anchor"])
def test_one_expert_step_matches_jax(frozen):
    """4 games to cap 30 at depth 1, mix 0.5, tau 0.02, imitation-sharp:
    (30, 4) records, S = 120 rows and 30 augmentation slots."""
    jcfg = JLOOP.TrainConfig(**EXPERT_RECIPE, expert_bf16=frozen,
                             anchor_kl=0.0 if frozen else 0.5)
    tcfg = TLOOP.TrainConfig(**EXPERT_RECIPE, expert_bf16=frozen,
                             anchor_kl=0.0 if frozen else 0.5, device="cpu")
    params = jmlp.init(jax.random.key(3), STUDENT, zero_heads=False)
    tparams = jmlp.init(jax.random.key(8), TEACHER, zero_heads=False)

    # JAX: the rollout with its teacher and coefs, then process at step 1.
    if frozen:
        jcoefs = JS.SearchCoefs(**TEACHER_COEFS)
        kw = dict(expert_apply=lambda q, x: jmlp.apply(q, TEACHER, x), expert_params=tparams)
    else:
        jcoefs = JS.coefs_from_moments(jax_moments(), jnp.int32(1), jcfg.points_weight,
                                       jcfg.monotonicity_weight, jcfg.emptiness_weight,
                                       jcfg.gamma, jcfg.rtg_beta)
        kw = {}
    go = jax.jit(lambda p, k: JR.rollout(
        lambda q, x: jmlp.apply(q, STUDENT, x), p, k, GAMES, CAP, expert_depth=1,
        expert_coefs=jcoefs, expert_mix=jcfg.expert_mix, expert_tau=jcfg.expert_tau,
        expert_bf16=jcfg.expert_bf16, **kw))
    jtraj = go(params, jax.random.key(9))
    jtraj_np = jax.tree.map(np.asarray, jtraj)
    labels = jmlp.param_labels(params)
    apply_train = lambda p, x, rng: jmlp.apply(p, STUDENT, x, train=True, rng=rng)  # noqa: E731
    janchor = (None if frozen else
               (lambda p, x: jmlp.apply(p, STUDENT, x), params, jcfg.anchor_kl))
    ocfg = dict(learning_rate=1e-3, critic_lr=3e-4)
    jprocess = JLOOP.make_process_fn(jcfg, apply_train, labels, JU.make_optimize_fn(
        apply_train, labels, jopt.OptimizerConfig(**ocfg), jcfg.batch_size, jcfg.ppo_epochs,
        kl_diagnostic=False, objective="imitation_sharp", anchor=janchor))
    k_proc = jax.random.key(7)
    jparams, _, jmoments, jout = jprocess(params, jopt.init(params), jtraj, jax_moments(),
                                          k_proc, jnp.int32(1), jnp.float32(0.02))
    plan, perm = jax_process_draws(jcfg, k_proc, jtraj.valid.reshape(-1))

    # The port: the trainer's own teacher arguments and objective.
    model = port_model(params, STUDENT)
    teacher, tcoefs = None, None
    if frozen:
        teacher = TS.BF16Leaves(port_model(tparams, TEACHER)).eval()
        tcoefs = TS.SearchCoefs(**TEACHER_COEFS)
    args = TLOOP.expert_args(tcfg, teacher, tcoefs, port_moments(), 1)
    if not frozen:
        assert args["expert_model"] is None
        for f in ("sigma", "mu"):
            np.testing.assert_allclose(float(getattr(args["expert_coefs"], f)),
                                       float(getattr(jcoefs, f)), rtol=1e-6)
    boards, actions, spawns = injected(jtraj_np, GAMES, CAP)
    ttraj = TR.rollout(model, GAMES, CAP, boards=boards, actions=actions, spawns=spawns, **args)
    assert_replays(ttraj, jtraj_np)
    anchor = None if frozen else (port_model(params, STUDENT).requires_grad_(False), 0.5)
    assert TLOOP.objective(tcfg) == "imitation_sharp"
    tprocess = TLOOP.make_process_fn(tcfg, TU.make_optimize_fn(
        model, param_labels(model), topt.OptimizerConfig(**ocfg), tcfg.batch_size,
        tcfg.ppo_epochs, kl_diagnostic=False, objective=TLOOP.objective(tcfg), anchor=anchor))
    tmoments, tout = tprocess(topt.init(dict(model.named_parameters())), ttraj, port_moments(),
                              1, 0.02, aug_plan=plan, perm_draws=perm)
    got = assert_step_matches(model, tmoments, tout, jparams, jmoments, jout)
    assert got["num_batches"] >= 3 and got["augmented_samples"] > 0
    # Half the games took the expert's moves, and the teacher is not the
    # policy: some policy moves differ from its labels.
    assert (jtraj_np.action[:, :2] == jtraj_np.target_action[:, :2]).all()
    assert (jtraj_np.action[:, 2:] != jtraj_np.target_action[:, 2:]).any()


# --- the CLI ----------------------------------------------------------------

TINY = ["train", "--episodes", "4", "--batch-size", "32", "-H", "16", "--num-layers", "2",
        "--scan-cap", "40", "--points", "0.1", "--mono", "1.0", "--upsample-ratio", "0.25",
        "--warmup-steps", "1", "--entropy", "0.001", "--dropout", "0.1", "--print-freq", "100",
        "--eval-freq", "2", "--eval-games", "4", "--rtg-beta", "0.9", "--gamma", "0.995",
        "--expert-iter", "--expert-depth", "1", "--expert-mix", "0.5", "--expert-bf16",
        "--device", "cpu"]
ANCHOR = ["--anchor-kl", "0.5"]


@pytest.fixture(scope="module")
def teacher_dir(tmp_path_factory):
    """A 2-step exact PPO run of a tiny MLP: a checkpoint with best_model and
    a train_state whose moments calibrate the search."""
    d = tmp_path_factory.mktemp("teacher")
    cli.main(["train", "--episodes", "4", "--batch-size", "64", "-H", "12", "--num-layers",
              "1", "--steps", "3", "--scan-cap", "60", "--points", "0.1", "--mono", "1.0",
              "--rtg-beta", "0.9", "--warmup-steps", "0", "--eval-freq", "1", "--eval-games",
              "2", "--print-freq", "100", "--checkpoint-dir", str(d), "--device", "cpu"])
    return d


@pytest.fixture(scope="module", params=["frozen_anchor", "live"])
def expert_runs(request, teacher_dir, tmp_path_factory):
    """4 steps straight (``a``), and the same run cut and resumed (``b``).

    The anchored run (frozen teacher, --anchor-kl 0.5) is cut after step 0:
    the anchor is the policy as the run starts, taken again at a resume (as
    the reference takes it), and only step 0 (learning-rate multiplier 0)
    leaves the policy where a straight run's anchor has it. The live
    teacher's run, without an anchor, is cut after step 1, once the policy
    and the moments its coefs come from have moved."""
    base = tmp_path_factory.mktemp(f"expert_{request.param}")
    frozen = request.param == "frozen_anchor"
    flags = TINY + (["--expert-src", str(teacher_dir)] + ANCHOR if frozen else [])

    def run(name, steps, *extra):
        cli.main(flags + ["--steps", str(steps), "--checkpoint-dir", str(base / name),
                          "--log-dir", str(base / f"log_{name}_{steps}"), *extra])

    run("a", 4)
    run("b", 1 if frozen else 2)
    run("b", 4, "--resume")
    return request.param, base


def test_expert_resume_is_bit_identical(expert_runs, capsys):
    name, base = expert_runs
    a, b = _npz(base / "a" / "train_state.npz"), _npz(base / "b" / "train_state.npz")
    assert set(a) == set(b)
    for k in a:
        if k != "__manifest__":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert not (base / "a" / "env_carry.npz").exists()
    (log,) = (base / "log_a_4").glob("*.jsonl")
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    assert [x["step"] for x in lines if "eval/avg_score" in x] == [2]
    assert all(np.isfinite(v) for x in lines for v in x.values() if isinstance(v, float))
    manifest = json.loads((base / "a" / "train_state.json").read_text())
    assert manifest["config"]["expert_iter"]
    assert manifest["config"]["anchor_kl"] == (0.0 if name == "live" else 0.5)
    assert (manifest["config"]["expert_src"] is None) == (name == "live")


def test_expert_run_prints_its_teacher_and_anchor(teacher_dir, tmp_path, capsys):
    cli.main(TINY + ANCHOR + ["--expert-src", str(teacher_dir), "--steps", "1",
                              "--checkpoint-dir", str(tmp_path)])
    out = capsys.readouterr().out
    coefs = jload_coefs(str(teacher_dir))
    assert (f"Expert iteration: FROZEN depth-1 expectimax teacher from {teacher_dir} "
            f"(sigma={coefs.sigma:.1f}, mu={coefs.mu:.1f})") in out
    assert "Anchor KL trust region: strength 0.5 vs the run-start policy" in out
    cli.main(TINY + ["--steps", "1", "--checkpoint-dir", str(tmp_path / "live")])
    out = capsys.readouterr().out
    assert ("Expert iteration: depth-1 expectimax rollout, imitation + value objective"
            in out and "Anchor KL" not in out)


def test_expert_checkpoint_reads_in_jax(expert_runs, tmp_path):
    _, base = expert_runs
    ck = base / "a"
    manifest = json.loads((ck / "train_state.json").read_text())
    params = jmlp.init(jax.random.key(0), JMLPConfig(**manifest["model_config"]))
    tree = dict(params=params, opt_state=jopt.init(params, jmlp.param_labels(params)),
                moments=JA.RtgMoments.initial(), key=jax.random.key_data(jax.random.key(0)))
    loaded, m = JCKPT.load_checkpoint(ck, "train_state", tree)
    assert m["train_step"] == 3
    got = _npz(ck / "train_state.npz")
    for k, v in _flat(loaded["params"]).items():
        np.testing.assert_array_equal(v, got[f"['params']{key_path(k)}"], err_msg=k)
    # The JAX package's search calibration of the run, as the port reads it.
    want, mine = jload_coefs(str(ck)), TLOOP.load_teacher(
        TLOOP.TrainConfig(expert_src=str(ck), device="cpu"), "cpu")[1]
    for f in want._fields:
        np.testing.assert_allclose(getattr(mine, f), getattr(want, f), rtol=1e-6, err_msg=f)


def test_packed_expert_iter_raises(tmp_path):
    with pytest.raises(ValueError, match="--packed does not support --expert-iter"):
        cli.main(["train", "--packed", "--expert-iter", "--steps", "1", "--checkpoint-dir",
                  str(tmp_path), "--device", "cpu"])
    assert not any(tmp_path.iterdir())
    TLOOP.check_ported(cli.train_config(["--expert-iter", "--anchor-kl", "0.5", "--device",
                                         "cpu"]))


# --- full width ---------------------------------------------------------------


def test_expF_student_and_expA_teacher_at_full_width():
    """The committed expF student (JAX-written, step 200) and its frozen
    expA teacher through the trainer's loaders; a depth-1 expert rollout of
    4 games x 3 trips at the recipe's mix 0.5, tau 0.02, bf16 leaves,
    replayed against the JAX package's."""
    ckpt = ROOT / "checkpoints_expF"
    manifest = json.loads((ckpt / "train_state.json").read_text())
    fields = set(TLOOP.TrainConfig.__dataclass_fields__)
    cfg = TLOOP.TrainConfig(**{k: v for k, v in manifest["config"].items() if k in fields},
                            device="cpu")
    cfg.expert_src, cfg.expert_depth = str(ROOT / "checkpoints_expA"), 1
    _, model, _ = TLOOP.build_model(cfg)
    _, moments, _, m = TLOOP.load_train_state(ckpt, model, "cpu")
    model.eval()
    assert m["train_step"] == 200 and (cfg.hidden_size, cfg.num_layers) == (384, 3)
    teacher, coefs = TLOOP.load_teacher(cfg, "cpu")
    assert isinstance(teacher, TS.BF16Leaves) and not teacher.training

    jparams, jmc, _ = jload_model(ckpt)
    # best_model.npz (step 200's best eval) is not the train state; the
    # student rollout needs the train state's parameters.
    jtree = dict(params=jparams, opt_state=jopt.init(jparams, jmlp.param_labels(jparams)),
                 moments=JA.RtgMoments.initial(), key=jax.random.key_data(jax.random.key(0)))
    jstate, _ = JCKPT.load_checkpoint(ckpt, "train_state", jtree)
    jt_params, jt_mc, _ = jload_model(ROOT / "checkpoints_expA")
    jcoefs = jload_coefs(str(ROOT / "checkpoints_expA"))
    for f in jcoefs._fields:
        np.testing.assert_allclose(getattr(coefs, f), getattr(jcoefs, f), rtol=1e-6, err_msg=f)
    go = jax.jit(lambda p, k: JR.rollout(
        lambda q, x: jmlp.apply(q, jmc, x), p, k, 4, 3, expert_depth=1, expert_coefs=jcoefs,
        expert_mix=cfg.expert_mix, expert_tau=cfg.expert_tau, expert_bf16=True,
        expert_apply=lambda q, x: jmlp.apply(q, jt_mc, x), expert_params=jt_params))
    jtraj = jax.tree.map(np.asarray, go(jstate["params"], jax.random.key(4)))
    boards, actions, spawns = injected(jtraj, 4, 3)
    ttraj = TR.rollout(model, 4, 3, boards=boards, actions=actions, spawns=spawns,
                       **TLOOP.expert_args(cfg, teacher, coefs, moments, 201))
    assert_replays(ttraj, jtraj)
    assert set(INT_FIELDS) < set(TR.Trajectory._fields)
    soft = jtraj.target_probs[jtraj.valid]
    assert ((soft > 0) & (soft < 1)).any()


def test_committed_expF_resumes_through_the_cli(tmp_path, capsys):
    """A copy of checkpoints_expF resumed for one step of its recipe at a
    tiny size on the CPU (4 games to cap 6, depth 1): the JAX run's teacher
    and calibration load, and the step-200 train_state is written as step
    201, never over the committed files."""
    for f in (ROOT / "checkpoints_expF").glob("train_state.*"):
        shutil.copy(f, tmp_path)
    cli.main(["train", "--steps", "202", "--episodes", "4", "--batch-size", "4096", "--lr",
              "1e-3", "--critic-lr", "1e-3", "-H", "384", "--num-layers", "3", "--gamma",
              "0.995", "--entropy", "0.001", "--dropout", "0.0", "--points", "0.10", "--mono",
              "1.0", "--critic", "1.0", "--rtg-beta", "0.9", "--warmup-steps", "20",
              "--upsample-ratio", "0.25", "-t", "mlp", "--no-kl-diagnostic", "--expert-iter",
              "--expert-depth", "1", "--expert-mix", "0.5", "--expert-bf16", "--expert-src",
              str(ROOT / "checkpoints_expA"), "--decouple-critic", "--print-freq", "100",
              "--checkpoint-dir", str(tmp_path), "--scan-cap", "2560", "--max-steps", "6",
              "--resume", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Resumed from step 201" in out and "Trained 1 steps, 24 env steps" in out
    assert "Expert iteration: FROZEN depth-1 expectimax teacher" in out
    assert json.loads((tmp_path / "train_state.json").read_text())["train_step"] == 201
    assert json.loads((ROOT / "checkpoints_expF" / "train_state.json").read_text())[
        "train_step"] == 200
