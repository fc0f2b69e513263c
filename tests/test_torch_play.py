"""The port's demo play and terminal clients against the JAX package's, on
injected draws: ``play_best_of`` (the exact rollout, its best game) and
``search_play_best`` (expectimax play, move by move) give the JAX
functions' dicts; ``watch_agent`` (sampled, and by depth-1 search) and
``human_play`` print the JAX clients' transcripts byte for byte when the
spawns of the JAX clients' oracle game are replayed; the models smoke
prints the JAX parameter counts; the entry points raise without a card.

Tolerances: every integer and board of the dicts bit-exact, the entropy of
sampled play to 1e-5 (float32 log-softmaxes taken in another order),
transcripts byte-identical."""

import random
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_engine import one_torch_thread, replay_draws  # noqa: F401
from tests.test_torch_export import SMALL, small_jax_params, write_jax_best_model
from tests.test_torch_rollout_exact import injected, port_model
from tests.test_torch_search import _jax_search_drive
from tests.test_torch_search import exp_a  # noqa: F401  (fixture)
from tpu2048.algo import rollout as JR
from tpu2048.algo import search as JS
from tpu2048.env import oracle
from tpu2048.models import MLPConfig as JMLPConfig
from tpu2048.models import mlp as jmlp
from tpu2048.train import evaluate as JEVAL
from tpu2048.train import play_cli as jplay
from tpu2048_torch.train import cli
from tpu2048_torch.train import evaluate as TEVAL
from tpu2048_torch.train import play_cli as tplay
from tpu2048_torch.train import warmstart

ROOT = Path(__file__).resolve().parent.parent
ENTROPY_TOL = 1e-5


def assert_same_episode(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in ("total_points", "total_steps", "final_state"):
        assert got[k] == want[k], k
    assert len(got["moves"]) == len(want["moves"])
    for t, (g, w) in enumerate(zip(got["moves"], want["moves"])):
        assert g.keys() == w.keys(), t
        for k in g:
            if k == "entropy":
                np.testing.assert_allclose(g[k], w[k], rtol=ENTROPY_TOL,
                                           atol=ENTROPY_TOL, err_msg=f"move {t}")
            else:
                assert g[k] == w[k], (t, k)


@pytest.mark.parametrize("games,cap,seed", [(6, 50, 2), (4, 2000, 5)])
def test_play_best_of_replays_jax(games, cap, seed, capsys):
    """Some games cut by the cap, or every game to its end."""
    cfg = JMLPConfig(hidden_dim=32, num_layers=2)
    params = jmlp.init(jax.random.key(3), cfg, zero_heads=False)
    want = JEVAL.play_best_of(params, cfg, "mlp", num_games=games, seed=seed,
                              max_steps=cap)
    jout = capsys.readouterr().out
    traj = jax.jit(lambda p, k: JR.rollout(lambda q, x: jmlp.apply(q, cfg, x), p, k,
                                           games, cap))(params, jax.random.key(seed))
    traj = jax.tree.map(np.asarray, traj)
    boards, actions, spawns = injected(traj, games, cap)
    got = TEVAL.play_best_of(port_model(params, cfg), games, seed, cap, boards=boards,
                             actions=actions, spawns=spawns)
    assert capsys.readouterr().out == jout
    assert_same_episode(got, want)
    assert len(got["moves"]) > 10


def test_play_best_of_is_seeded():
    model = port_model(jmlp.init(jax.random.key(4), JMLPConfig(hidden_dim=16), False),
                       JMLPConfig(hidden_dim=16))
    a, b = (TEVAL.play_best_of(model, 3, seed=7, max_steps=40) for _ in range(2))
    assert a == b and len(a["moves"]) > 0


def test_search_play_best_replays_jax(exp_a, capsys):  # noqa: F811
    """checkpoints_expA at depth 1, 4 games, 64 moves (the boards and
    spawns of the JAX search test that replays move for move)."""
    params, apply_fn, model, coefs = exp_a
    n, steps, env_seed = 4, 64, 42
    jcfg = JMLPConfig(**model.config.to_dict())
    want = JEVAL.search_play_best(params, jcfg, "mlp", num_games=n, env_seed=env_seed,
                                  coefs=JS.SearchCoefs(**coefs._asdict()), depth=1,
                                  max_steps=steps)
    jout = capsys.readouterr().out
    drive = _jax_search_drive(apply_fn, params, n, steps, jax.random.key(env_seed), coefs,
                              1, 0)
    spawns = np.full((steps, 2, n), 0.5, np.float32)
    for t, live in enumerate(drive["alive"]):
        spawns[t][:, live] = replay_draws(drive["moved"][t][live], drive["after"][t][live])
    got = TEVAL.search_play_best(model, n, env_seed, coefs, 1, steps,
                                 boards=torch.as_tensor(drive["boards0"]),
                                 spawns=torch.as_tensor(spawns))
    assert capsys.readouterr().out == jout
    assert_same_episode(got, want)
    assert got["total_points"] > 0 and len(got["moves"]) == steps


def test_search_play_best_records_ended_games():
    """Every game to its end: the moves stop at the end, the reference's
    total_steps is moves - 1, and the points add up."""
    cfg = JMLPConfig(hidden_dim=16)
    model = port_model(jmlp.init(jax.random.key(5), cfg, zero_heads=False), cfg)
    ep = TEVAL.search_play_best(model, 3, env_seed=9, depth=1, max_steps=3000)
    assert ep["total_steps"] == len(ep["moves"]) - 1
    assert ep["total_points"] == sum(m["points_earned"] for m in ep["moves"])
    assert ep["final_state"] == ep["moves"][-1]["result_state"]
    assert all(m["entropy"] == 0.0 for m in ep["moves"])


# --- the terminal clients ----------------------------------------------------


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """A random H=16 MLP (short games) as a JAX-written best_model, with
    checkpoints_expA's train_state beside it for calibrated search coefs."""
    d = tmp_path_factory.mktemp("tiny_play")
    write_jax_best_model(d, small_jax_params("mlp", seed=6), SMALL["mlp"], "mlp")
    for ext in (".npz", ".json"):
        shutil.copy2(ROOT / "checkpoints_expA" / f"train_state{ext}", d / f"train_state{ext}")
    return d


class OracleGame:
    """Records the JAX clients' oracle game: its first board and the spawn
    draws that replay each move's spawn on the port's engine."""

    def __init__(self, monkeypatch):
        self.first, self.draws = None, []
        reset, step = oracle.reset, oracle.step

        def rec_reset(rng=None):
            self.first = reset(rng)
            return self.first

        def rec_step(grid, d, rng=None):
            out = step(grid, d, rng)
            moved = oracle.simulate_move(grid, d)[0]
            self.draws.append(replay_draws(np.array([moved]), np.array([out[0]])))
            return out

        monkeypatch.setattr(oracle, "reset", rec_reset)
        monkeypatch.setattr(oracle, "step", rec_step)
        monkeypatch.setattr(jplay.os, "system", lambda cmd: 0)
        monkeypatch.setattr(jplay.time, "sleep", lambda s: None)

    def replay(self) -> dict:
        spawns = np.stack(self.draws) if self.draws else np.zeros((0, 2, 1), np.float32)
        return dict(board=np.array(self.first, np.int32), spawns=torch.as_tensor(spawns))


@pytest.mark.parametrize("search,seed", [(0, 3), (1, 4)])
def test_watch_agent_prints_the_jax_transcript(search, seed, tiny_ckpt, monkeypatch, capsys):
    random.seed(seed)
    game = OracleGame(monkeypatch)
    jplay.watch_agent(str(tiny_ckpt), delay=0.0, seed=seed, search=search)
    want = capsys.readouterr().out
    slept = []
    out = tplay.watch_agent(str(tiny_ckpt), delay=0.25, seed=seed, search=search,
                            device="cpu", sleep=slept.append, **game.replay())
    assert capsys.readouterr().out == want
    assert out["moves"] == len(game.draws) > 20 and slept == [0.25] * (out["moves"] - 1)
    assert f"Final Score: {out['score']}" in want and "Game Over" in want
    if search:
        assert "Expectimax move selection (depth=1, coefs=SearchCoefs(" in want


def test_watch_agent_untrained_agent_plays_a_game(capsys):
    """No model: an untrained H=64 MLP from the seed; the game is played to
    its end with legal moves, and the same seed plays the same game."""
    a = tplay.watch_agent(None, delay=0.0, seed=1, device="cpu", sleep=lambda s: None)
    text = capsys.readouterr().out
    b = tplay.watch_agent(None, delay=0.0, seed=1, device="cpu", sleep=lambda s: None)
    assert capsys.readouterr().out == text and a["final_board"] == b["final_board"]
    assert text.startswith("Playing with random agent (no model specified)")
    assert not any(oracle.direction_is_legal(a["final_board"], d) for d in range(4))
    for grid, action in a["history"]:
        assert oracle.direction_is_legal(grid, action)


@pytest.mark.parametrize("seed", [0, 1])
def test_human_play_prints_the_jax_transcript(seed, monkeypatch, capsys):
    """About 40 scripted keys (WASD in both cases, arrow keys, an unknown
    key, moves that are illegal), then q."""
    rng = np.random.default_rng(seed)
    pool = ["w", "a", "s", "d", "W", "D", "\x1b[A", "\x1b[B", "\x1b[C", "\x1b[D", "x"]
    keys = [pool[i] for i in rng.integers(0, len(pool), 40)] + ["q"]
    random.seed(seed)
    game = OracleGame(monkeypatch)
    it = iter(keys)
    monkeypatch.setattr(jplay, "_get_keypress", lambda: next(it))
    jplay.human_play()
    want = capsys.readouterr().out
    monkeypatch.setattr(tplay.os, "system", lambda cmd: 0)
    it2 = iter(keys)
    out = tplay.human_play(device="cpu", get_key=lambda: next(it2), **game.replay())
    assert capsys.readouterr().out == want
    assert out["moves"] == len(game.draws) > 10
    assert "Can't move" in want and "Invalid key" in want and "Thanks for playing" in want


def test_models_smoke_prints_the_jax_counts(capsys):
    from tpu2048.models import __main__ as jmodels
    from tpu2048_torch.models import __main__ as tmodels

    jmodels.main()
    want = capsys.readouterr().out
    got = tmodels.main(["--device", "cpu"])
    text = capsys.readouterr().out

    def lines(s, start):
        return [ln for ln in s.splitlines() if ln.startswith(start)]

    for start in ("GameMLP:", "GameURM:", "Action logits shape:", "Value shape:", "==="):
        assert lines(text, start) == lines(want, start), start
    assert got["GameMLP"] > 0 and got["GameURM"] > 0
    assert torch.isfinite(got["urm_logits"]).all() and got["logits"].shape == (3, 4)


@pytest.mark.parametrize("argv", [
    ["export-demo", "--model", str(ROOT / "checkpoints_expG"), "--output", "{tmp}"],
    ["play", "--model", str(ROOT / "checkpoints_expA")],
    ["human"],
    ["warmstart"],
], ids=["export-demo", "play", "human", "warmstart"])
def test_cuda_without_a_card_raises(argv, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the CPU-only machine")
    argv = [a.replace("{tmp}", str(tmp_path / "out")) for a in argv]
    with pytest.raises(RuntimeError, match="cuda"):
        if argv[0] == "warmstart":
            warmstart.main(["--ckpt-dir", str(tmp_path / "ck"),
                            "--src-dir", str(ROOT / "checkpoints_expA")])
        else:
            cli.main(argv)
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("argv,named", [
    (["bench"], "ROADMAP.md"),
    (["export-demo", "--platform", "cpu"], "--platform"),
    (["play", "--platform", "cpu"], "--platform"),
    (["human", "--platform", "cpu"], "--platform"),
    (["evaluate", str(ROOT / "checkpoints_expG"), "--platform", "cpu"], "--platform"),
], ids=["bench", "export-demo", "play", "human", "evaluate"])
def test_unported_subcommand_and_platform_raise(argv, named):
    with pytest.raises(NotImplementedError, match=named):
        cli.main(argv)


def test_cli_play_runs_on_the_cpu(tiny_ckpt, capsys):
    cli.main(["play", "--model", str(tiny_ckpt), "--delay", "0", "--search", "1",
              "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Expectimax move selection (depth=1" in out and "Final Score:" in out
