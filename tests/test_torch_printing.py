"""The port's episode fetches, printers and viz exporters
(tpu2048_torch/train/loop.py::fetch_episode, fetch_packed_episode;
tpu2048_torch/utils/{printing,viz_export}.py) against the JAX package's.

* ``fetch_episode`` of an exact rollout's best lane (the port's replayed
  rollout beside the JAX one, the same advantage) and
  ``fetch_packed_episode`` of a recorder (the JAX recorder's fields): the
  same dict, key order included. The entropies of the replayed rollout to
  1e-5 (float32 policy); everything else exact (the heuristics are
  bit-exact, tests/test_torch_heuristics.py).
* Given the same episode, the printers write the same lines and the
  exporters the same JSON text; its keys are the committed
  viz_data_expG/step_000000.json's."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_capture import as_numpy, jax_trips, to_port
from tests.test_torch_engine import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_rollout_exact import injected, jax_rollout, port_model
from tpu2048.algo import rollout as JR
from tpu2048.algo.advantage import RewardWeights as JWeights
from tpu2048.algo.capture import EpisodeRecorder as JRecorder
from tpu2048.models import MLPConfig as JMLPConfig
from tpu2048.models import mlp as jmlp
from tpu2048.train import loop as JLOOP
from tpu2048.utils import printing as JP
from tpu2048.utils import viz_export as JV
from tpu2048_torch.algo import rollout as TR
from tpu2048_torch.algo.advantage import RewardWeights as TWeights
from tpu2048_torch.train import loop as TLOOP
from tpu2048_torch.utils import printing as TP
from tpu2048_torch.utils import viz_export as TV

ROOT = Path(__file__).resolve().parent.parent
COMMITTED_VIZ = ROOT / "viz_data_expG" / "step_000000.json"
TOL = 1e-5
WEIGHTS = dict(points=0.1, smoothness=0.5, max_tile=0.25, corner=1.5, adjacency=0.75,
               chain=0.2, monotonicity=1.0, emptiness=0.5, topological=0.05)


class Lines:
    """A logger that keeps what it is given to print."""

    def __init__(self):
        self.lines = []

    def print(self, message=""):
        self.lines.append(message)


def assert_same_episode(got: dict, want: dict, float_keys=()) -> None:
    assert list(got) == list(want)
    for k in want:
        if k != "moves":
            assert got[k] == want[k], k
    assert len(got["moves"]) == len(want["moves"])
    for t, (g, w) in enumerate(zip(got["moves"], want["moves"])):
        assert list(g) == list(w), t
        for k in w:
            if k in float_keys:
                np.testing.assert_allclose(g[k], w[k], rtol=TOL, atol=TOL,
                                           err_msg=f"move {t} {k}")
            else:
                assert g[k] == w[k], (t, k, g[k], w[k])


@pytest.fixture(scope="module")
def exact():
    """A JAX exact rollout and the port's replay of it, with the JAX
    episode of its best lane (heuristic deltas included)."""
    cfg = JMLPConfig(hidden_dim=32, num_layers=2)
    params = jmlp.init(jax.random.key(3), cfg, zero_heads=False)
    jtraj = jax_rollout(params, cfg, 8, 400, seed=1)
    boards, actions, spawns = injected(jtraj, 8, 400)
    ttraj = TR.rollout(port_model(params, cfg), 8, 400, boards=boards, actions=actions,
                       spawns=spawns)
    adv = np.random.default_rng(0).normal(size=jtraj.valid.shape).astype(np.float32)
    idx = int(np.argmax(jtraj.total_points))
    want = JLOOP.fetch_episode(jax_trajectory(jtraj), jnp.asarray(adv), idx,
                               heur_fn=JLOOP.make_episode_heuristics_fn())
    return jtraj, ttraj, adv, idx, want


def jax_trajectory(np_traj):
    return JR.Trajectory(**{k: jnp.asarray(v) for k, v in np_traj._asdict().items()})


def test_fetch_episode_matches(exact):
    jtraj, ttraj, adv, idx, want = exact
    assert want["moves"][-1]["monotonicity_after"] == 0.0  # the game ended
    got = TLOOP.fetch_episode(ttraj, torch.as_tensor(adv), idx,
                              heur_fn=TLOOP.make_episode_heuristics_fn())
    assert_same_episode(got, want, float_keys=("entropy",))
    plain = TLOOP.fetch_episode(ttraj, None, idx)
    assert "smoothness_delta" not in plain["moves"][0]
    assert plain["moves"][0]["advantage"] == 0.0


@pytest.mark.parametrize("cap", [12, 96], ids=["truncated", "whole"])
def test_fetch_packed_episode_matches(cap):
    params = jmlp.init(jax.random.key(7), JMLPConfig(hidden_dim=32, num_layers=1),
                       zero_heads=False)
    _, steps = jax_trips(cap, params)
    rec = steps[-1][2]
    jrec = JRecorder(**{k: jnp.asarray(v) for k, v in rec.items()})
    want = JLOOP.fetch_packed_episode(jrec, heur_fn=JLOOP.make_episode_heuristics_fn(),
                                      mono_fn=JLOOP.make_packed_mono_fn())
    got = TLOOP.fetch_packed_episode(to_port(as_numpy(jrec)),
                                     heur_fn=TLOOP.make_episode_heuristics_fn(),
                                     mono_fn=TLOOP.make_packed_mono_fn())
    assert ("truncated_at" in want) == (cap == 12)
    assert_same_episode(got, want)
    empty = to_port(as_numpy(jrec._replace(best_len=jnp.int32(0))))
    assert TLOOP.fetch_packed_episode(empty) is None


@pytest.fixture(scope="module")
def episode(exact):
    return exact[-1]


@pytest.mark.parametrize("weights", ["recipe", "all", "none"])
def test_breakdown_prints_the_same_lines(episode, weights):
    kw = dict(recipe=dict(points=0.1, monotonicity=1.0), all=WEIGHTS, none={})[weights]
    jlog, tlog = Lines(), Lines()
    JP.print_episode_breakdown(jlog, episode, JWeights(**kw), 0.995)
    TP.print_episode_breakdown(tlog, episode, TWeights(**kw), 0.995)
    assert tlog.lines == jlog.lines and len(jlog.lines) > 10


@pytest.mark.parametrize("n", [1, 3, 10_000])
def test_last_steps_and_final_state_print_the_same_lines(episode, n):
    jlog, tlog = Lines(), Lines()
    for mod, log in ((JP, jlog), (TP, tlog)):
        mod.print_last_steps(log, episode, n)
        mod.print_final_state(log, episode)
        log.print(mod.format_grid([[0, 1, 11, 17]] * 4, indent="> "))
    assert tlog.lines == jlog.lines
    for mod, log in ((JP, jlog), (TP, tlog)):
        mod.print_last_steps(log, {"moves": []}, n)
        mod.print_episode_breakdown(log, {"moves": []}, JWeights(), 0.99)
    assert tlog.lines == jlog.lines


def test_viz_export_writes_the_same_json(episode, tmp_path):
    jpath = JV.export_episode_visualization(tmp_path / "j", 1234, episode,
                                            JWeights(**WEIGHTS), 0.995)
    tpath = TV.export_episode_visualization(tmp_path / "t", 1234, episode,
                                            TWeights(**WEIGHTS), 0.995)
    assert tpath.name == jpath.name == "step_001234.json"
    assert tpath.read_text() == jpath.read_text()
    got = json.loads(tpath.read_text())
    committed = json.loads(COMMITTED_VIZ.read_text())
    assert list(got) == list(committed)
    assert list(got["moves"][0]) == list(committed["moves"][0])
    assert list(got["moves"][0]["rewards"]) == list(committed["moves"][0]["rewards"])


def test_best_game_export_writes_the_same_json(episode, tmp_path, capsys):
    meta = {"mode": "sampled", "games": 8}
    for m in (None, meta):
        j = JV.export_best_game(episode, tmp_path / "j" / "best_game.json", meta=m)
        t = TV.export_best_game(episode, tmp_path / "t" / "best_game.json", meta=m)
        assert t.read_text() == j.read_text()
    out = capsys.readouterr().out.splitlines()
    assert out[1].replace("/t/", "/j/") == out[0]


def test_smoke_viz_keys_are_the_committed_files():
    """chip_smoke.py checks the viz JSON it writes against these keys (it
    also runs from copies of the repository without viz_data_expG)."""
    import chip_smoke

    committed = json.loads(COMMITTED_VIZ.read_text())
    assert chip_smoke.VIZ_KEYS == (tuple(committed), tuple(committed["moves"][0]),
                                   tuple(committed["moves"][0]["rewards"]))
