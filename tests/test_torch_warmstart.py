"""The port's warm start (tpu2048_torch/train/warmstart.py) against
scripts/warmstart_from_best.py: the RTG moments of a replayed JAX rollout
(the policy's, and the depth-2 expert's) equal the script's; the
train_state it writes has the leaves, shapes, dtypes and manifest of the
script's; each package reads the other's, and the port's trainer resumes
both.

Tolerances: mu and E[G^2] to 1e-5 relative (float32 returns-to-go summed
in another order), the step count exact; the manifest and the key exact."""

import importlib.util
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_engine import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_export import SMALL, small_jax_params, write_jax_best_model
from tests.test_torch_rollout_exact import injected, port_model
from tpu2048.algo import advantage as JA
from tpu2048.algo import rollout as JR
from tpu2048.algo import search as JS
from tpu2048.models import mlp as jmlp
from tpu2048.ops import optimizer as jopt
from tpu2048.train import checkpoint as JCKPT
from tpu2048_torch.algo import advantage as TA
from tpu2048_torch.algo import rollout as TR
from tpu2048_torch.algo import search as TS
from tpu2048_torch.train import cli
from tpu2048_torch.train import loop as TLOOP
from tpu2048_torch.train import warmstart
from tpu2048_torch.train.evaluate import load_model_checkpoint as tload

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-5
GAMMA, POINTS, MONO = 0.995, 0.1, 1.0
COEFS = dict(points=0.1, mono=0.7, empt=0.3, sigma=2.5, mu=-0.4, gamma=0.97)


def jax_script():
    spec = importlib.util.spec_from_file_location(
        "warmstart_from_best", ROOT / "scripts" / "warmstart_from_best.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_moments(traj, gamma):
    """The script's moments: step rewards masked by valid, returns-to-go,
    float64 means over the valid steps."""
    w = JA.RewardWeights(points=POINTS, monotonicity=MONO)
    r = JA.step_rewards(traj.points, traj.mono_before, traj.mono_after,
                        traj.empt_before, traj.empt_after, w, gamma)
    r = jnp.where(traj.valid, r, 0.0)
    G = np.asarray(JA.returns_to_go(r, traj.valid, gamma))
    m = np.asarray(traj.valid, np.float64)
    return float((G * m).sum() / m.sum()), float((G * G * m).sum() / m.sum()), int(m.sum())


@pytest.mark.parametrize("depth,games,cap", [(0, 8, 60), (0, 3, 2000), (2, 2, 5)])
def test_measure_moments_matches_the_jax_script(depth, games, cap):
    """The policy's rollout (cut by the cap, or every game to its end) and
    the depth-2 expert's, with a short cap."""
    cfg = SMALL["mlp"]
    params = small_jax_params("mlp", seed=2)
    kw = dict(expert_depth=depth, expert_coefs=JS.SearchCoefs(**COEFS)) if depth else {}
    jtraj = jax.jit(lambda p, k: JR.rollout(lambda q, x: jmlp.apply(q, cfg, x), p, k,
                                            games, cap, **kw))(params, jax.random.key(123))
    jtraj = jax.tree.map(np.asarray, jtraj)
    want = jax_moments(jtraj, GAMMA)
    boards, actions, spawns = injected(jtraj, games, cap)
    tkw = dict(expert_depth=depth, expert_coefs=TS.SearchCoefs(**COEFS)) if depth else {}
    ttraj = TR.rollout(port_model(params, cfg), games, cap, boards=boards, actions=actions,
                       spawns=spawns, **tkw)
    np.testing.assert_array_equal(ttraj.action.numpy(), jtraj.action)
    got = warmstart.measure_moments(ttraj, TA.RewardWeights(points=POINTS, monotonicity=MONO),
                                    GAMMA)
    np.testing.assert_allclose(got[:2], want[:2], rtol=RTOL)
    assert got[2] == want[2] and got[1] > got[0] ** 2


@pytest.fixture(scope="module")
def warm(tmp_path_factory):
    """A random H=16 MLP's best_model, warm-started by the JAX script and by
    the port (CLI flags, --device cpu)."""
    root = tmp_path_factory.mktemp("warm")
    src = write_jax_best_model(root / "src", small_jax_params("mlp", seed=5), SMALL["mlp"],
                               "mlp")
    jax_script().main(str(root / "jax"), 300, GAMMA, POINTS, MONO, str(src), 4096, 0)
    moments = warmstart.main(
        ["--ckpt-dir", str(root / "port"), "--src-dir", str(src), "--train-step", "300",
         "--gamma", str(GAMMA), "--points", str(POINTS), "--mono", str(MONO),
         "--highest-score", "4096", "--device", "cpu"])
    return root, src, moments


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_port_train_state_is_the_scripts(warm):
    root, src, (mu, m2, n) = warm
    got, want = _npz(root / "port" / "train_state.npz"), _npz(root / "jax" / "train_state.npz")
    assert {k: (v.shape, v.dtype) for k, v in got.items()} == \
           {k: (v.shape, v.dtype) for k, v in want.items()}
    gm = json.loads(str(got.pop("__manifest__")))
    wm = json.loads(str(want.pop("__manifest__")))
    assert gm == wm and gm["train_step"] == 300 and gm["highest_score"] == 4096
    assert json.loads((root / "port" / "train_state.json").read_text()) == gm
    np.testing.assert_array_equal(got["['key']"], np.array([0, 20260818], np.uint32))
    np.testing.assert_array_equal(got["['key']"], want["['key']"])
    for k, v in got.items():
        if k.startswith("['params']"):
            np.testing.assert_array_equal(v, want[k], err_msg=k)
        elif k.startswith("['opt_state']"):
            assert not v.any(), k
    assert got["['moments'].mu"] == np.float32(mu) == got["['moments'].first_moment"]
    assert got["['moments'].m2"] == np.float32(m2) and n > 1000


def test_each_package_reads_the_others_train_state(warm):
    root, src, _ = warm
    params = small_jax_params("mlp")
    tree = dict(params=params, opt_state=jopt.init(params, jmlp.param_labels(params)),
                moments=JA.RtgMoments.initial(), key=jax.random.key_data(jax.random.key(0)))
    loaded, manifest = JCKPT.load_checkpoint(root / "port", "train_state", tree)
    assert manifest["train_step"] == 300 and manifest["config"] == {}
    assert float(loaded["moments"].m2) > 0
    for d in ("port", "jax"):
        model, _, _ = tload(src, "cpu")
        opt_state, moments, key, m = TLOOP.load_train_state(root / d, model, "cpu")
        assert m["train_step"] == 300 and key.tolist() == [0, 20260818]
        assert opt_state.step == 0 and not any(v.any() for v in opt_state.m.values())
        assert torch.isfinite(moments.m2) and moments.m2 > moments.mu ** 2


@pytest.mark.parametrize("which", ["port", "jax"])
def test_port_trainer_resumes_a_warm_start(warm, which, tmp_path, capsys):
    """One exact-episodes step of the port's trainer from each warm start."""
    root, _, _ = warm
    ck = tmp_path / which
    shutil.copytree(root / which, ck)
    cli.main(["train", "--episodes", "4", "--batch-size", "32", "-H", "16",
              "--num-layers", "2", "--steps", "302", "--scan-cap", "60",
              "--checkpoint-dir", str(ck), "--resume", "--device", "cpu",
              "--print-freq", "100"])
    assert "Resumed from step 301" in capsys.readouterr().out
    assert json.loads((ck / "train_state.json").read_text())["train_step"] == 301


def test_expert_depth_measures_under_the_expert(tmp_path, capsys):
    """--expert-depth 1: the source's coefs printed, 128 expert games."""
    src = write_jax_best_model(tmp_path / "src", small_jax_params("mlp", seed=7),
                               SMALL["mlp"], "mlp")
    mu, m2, n = warmstart.warm_start(str(tmp_path / "out"), 50, GAMMA, POINTS, MONO,
                                     str(src), 0, 1, "cpu")
    out = capsys.readouterr()
    assert "measuring moments under depth-1 expert play (SearchCoefs(" in out.out
    assert "PURE-EV" in out.err  # the source has no train_state to calibrate from
    assert np.isfinite([mu, m2]).all() and m2 > mu * mu and n > 128
