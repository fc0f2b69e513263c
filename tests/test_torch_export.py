"""The port's demo export (tpu2048_torch/train/export.py, utils/onnx_writer.py,
checkpoint.state_dict_to_params, the CLI's export-demo and train
--export-demo) against the JAX package's: for the same weights the same
bytes of model.onnx, model_weights.json and model_config.json.

Tolerances: the exported files byte-identical; the port's ONNX graph,
executed in numpy by tests/test_onnx.py, equal to the port's forward to
1e-5 (the MLP) and 1e-4 (the URM's recurrence, as tests/test_onnx.py holds
the JAX one)."""

import filecmp
import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tests.test_onnx import decode_model, execute
from tests.test_torch_engine import one_torch_thread  # noqa: F401  (autouse)
from tpu2048.models import MLPConfig as JMLPConfig
from tpu2048.models import URMConfig as JURMConfig
from tpu2048.models import mlp as jmlp
from tpu2048.models import urm as jurm
from tpu2048.train import checkpoint as JCKPT
from tpu2048.train import cli as jcli
from tpu2048.train.evaluate import load_model_checkpoint as jload
from tpu2048.train.evaluate import load_search_coefs as jcoefs
from tpu2048.train.export import export_demo_assets as jexport
from tpu2048_torch.models.encoding import encode_boards
from tpu2048_torch.models.mlp import GameMLP, MLPConfig
from tpu2048_torch.models.urm import GameURM, URMConfig
from tpu2048_torch.train import cli
from tpu2048_torch.train import export as TEXP
from tpu2048_torch.train.checkpoint import params_to_state_dict, state_dict_to_params
from tpu2048_torch.train.evaluate import load_model_checkpoint as tload
from tpu2048_torch.train.evaluate import load_search_coefs as tcoefs

ROOT = Path(__file__).resolve().parent.parent
ASSETS = ("model.onnx", "model_weights.json", "model_config.json")
SMALL = {"mlp": JMLPConfig(hidden_dim=16, num_layers=2),
         "urm": JURMConfig(hidden_dim=16, num_layers=2, num_heads=4, num_loops=3)}


def small_jax_params(model_type: str, seed: int = 1):
    init = jurm.init if model_type == "urm" else jmlp.init
    return init(jax.random.key(seed), SMALL[model_type], zero_heads=False)


def port_of(params, model_type: str):
    """The port model holding the JAX params ``params``."""
    if model_type == "urm":
        model = GameURM(URMConfig(**SMALL["urm"].to_dict()))
    else:
        model = GameMLP(MLPConfig(**SMALL["mlp"].to_dict()))
    model.load_state_dict(params_to_state_dict(jax.tree.map(np.asarray, params)))
    return model.eval()


def write_jax_best_model(ckpt_dir, params, cfg, model_type: str) -> Path:
    """A best_model checkpoint as the JAX train loop writes one."""
    JCKPT.save_checkpoint(ckpt_dir, "best_model", arrays_tree=dict(params=params),
                          manifest=dict(config=cfg.to_dict(), model_type=model_type,
                                        eval_avg_score=321.5, train_step=7))
    return Path(ckpt_dir)


def assert_same_files(a: Path, b: Path, names=ASSETS) -> None:
    for name in names:
        assert filecmp.cmp(a / name, b / name, shallow=False), name


@pytest.mark.parametrize("model_type", ["mlp", "urm"])
def test_state_dict_to_params_round_trips(model_type):
    model = (GameURM(URMConfig(hidden_dim=16), zero_heads=False,
                     generator=torch.Generator().manual_seed(3)) if model_type == "urm"
             else GameMLP(MLPConfig(hidden_dim=16, num_layers=3), zero_heads=False,
                          generator=torch.Generator().manual_seed(3)))
    tree = state_dict_to_params(model)
    back = params_to_state_dict(tree)
    sd = model.state_dict()
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    assert isinstance(tree["blocks"], list) and len(tree["blocks"]) == len(model.blocks)
    assert tree["stem"]["lin"]["w"].dtype == np.float32
    if model_type == "urm":
        cfg = model.config
        assert tree["init_hidden"][0].shape == (16, 16)
        assert tree["blocks"][1]["dwconv"]["w"].shape == (cfg.inter, cfg.conv_kernel)
    else:
        assert tree["blocks"][2]["ln"]["g"].shape == (16,)
    # A copy: the tree does not change with the model.
    w = tree["stem"]["lin"]["w"].copy()
    with torch.no_grad():
        model.stem.lin.w.add_(1.0)
    np.testing.assert_array_equal(tree["stem"]["lin"]["w"], w)


@pytest.mark.parametrize("source", ["checkpoints_expG", "checkpoints_urm_r5", "mlp", "urm"])
def test_exports_are_byte_identical(source, tmp_path):
    """model.onnx, model_weights.json and model_config.json (with the
    search coefs) of a committed checkpoint, or of random H=16 weights."""
    if source.startswith("checkpoints_"):
        ck = ROOT / source
        jparams, jcfg, jtype = jload(str(ck))
        model, tcfg, ttype = tload(ck, "cpu")
        jc, tc = jcoefs(ck), tcoefs(ck)
    else:
        jparams, jcfg, jtype = small_jax_params(source), SMALL[source], source
        model = port_of(jparams, source)
        tcfg, ttype = model.config, source
        jc = tc = None
    jexport(jparams, jcfg, jtype, None, tmp_path / "jax", search_coefs=jc)
    TEXP.export_demo_assets(model, tcfg, ttype, None, tmp_path / "port", search_coefs=tc)
    assert_same_files(tmp_path / "jax", tmp_path / "port")
    config = json.loads((tmp_path / "port" / "model_config.json").read_text())
    assert ("search_coefs" in config) == source.startswith("checkpoints_")
    # The tree in place of the model writes the same bytes.
    TEXP.export_demo_assets(state_dict_to_params(model), tcfg, ttype, None,
                            tmp_path / "tree", search_coefs=tc)
    assert_same_files(tmp_path / "jax", tmp_path / "tree")


@pytest.mark.parametrize("model_type,tol", [("mlp", 1e-5), ("urm", 1e-4)])
def test_port_onnx_runs_as_the_port_forward(model_type, tol, tmp_path):
    model = port_of(small_jax_params(model_type, seed=4), model_type)
    TEXP.export_demo_assets(model, model.config, model_type, None, tmp_path)
    nodes, inits, inputs, outputs = decode_model((tmp_path / "model.onnx").read_bytes())
    assert inputs == ["board_state"] and outputs == ["action_logits", "value"]
    boards = torch.as_tensor(np.random.default_rng(5).integers(0, 9, (5, 4, 4)),
                             dtype=torch.int32)
    x = encode_boards(boards)
    vals = execute(nodes, inits, {"board_state": x.numpy()})
    with torch.no_grad():
        logits, value = model(x)
    np.testing.assert_allclose(vals["action_logits"], logits.numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(vals["value"], value.numpy(), rtol=tol, atol=tol)


def test_port_imports_no_jax_and_no_tpu2048():
    """The port and chip_smoke.py import neither JAX nor the JAX package;
    the ONNX writer is the port's own copy."""
    import re

    from tpu2048_torch.utils import onnx_writer

    pattern = re.compile(r"^\s*(import|from) +(jax|tpu2048)\b", re.M)
    files = [*(ROOT / "tpu2048_torch").rglob("*.py"), ROOT / "chip_smoke.py"]
    assert [f for f in files if pattern.search(f.read_text())] == []
    assert Path(onnx_writer.__file__).parent == ROOT / "tpu2048_torch" / "utils"


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """A random H=16 MLP as a JAX-written best_model, with checkpoints_expA's
    train_state beside it for calibrated search coefs: its games are short."""
    d = tmp_path_factory.mktemp("tiny")
    write_jax_best_model(d, small_jax_params("mlp", seed=6), SMALL["mlp"], "mlp")
    for ext in (".npz", ".json"):
        shutil.copy2(ROOT / "checkpoints_expA" / f"train_state{ext}", d / f"train_state{ext}")
    return d


def _export_both(tmp_path, flags, monkeypatch):
    # The JAX CLI's persistent compile cache lives outside the checkout.
    monkeypatch.setattr(jcli, "_enable_compilation_cache", lambda: None)
    jcli.main(["export-demo", *flags, "--output", str(tmp_path / "jax")])
    cli.main(["export-demo", *flags, "--output", str(tmp_path / "port"), "--device", "cpu"])
    return tmp_path / "jax", tmp_path / "port"


@pytest.mark.parametrize("mode", ["sampled", "search", "game"])
def test_export_demo_cli_writes_the_jax_clis_files(mode, tiny_ckpt, tmp_path, capsys,
                                                   monkeypatch):
    """Every file the JAX CLI writes, under the same names; the assets and
    the checkpoint's copies byte-identical; the best game's own keys and
    play metadata (its moves come from other spawn streams)."""
    flags = ["--model", str(tiny_ckpt), "-n", "2", "--seed", "3"]
    if mode == "search":
        flags += ["--search", "--search-depth", "1"]
    if mode == "game":
        game = tmp_path / "game.json"
        game.write_text(json.dumps({"score": 12, "total_steps": 1, "moves": [
            {"step": 1, "action": "UP", "points_earned": 4}], "extra": 1}))
        flags += ["--game", str(game)]
    jdir, tdir = _export_both(tmp_path, flags, monkeypatch)
    files = sorted(p.name for p in jdir.iterdir())
    assert files == sorted(p.name for p in tdir.iterdir())
    assert {"best_game.json", "best_model.npz", "best_model.json", *ASSETS} == set(files)
    assert_same_files(jdir, tdir, ASSETS + ("best_model.npz", "best_model.json"))
    jgame = json.loads((jdir / "best_game.json").read_text())
    tgame = json.loads((tdir / "best_game.json").read_text())
    if mode == "game":
        assert_same_files(jdir, tdir, ("best_game.json",))
    else:
        assert jgame.keys() == tgame.keys() and jgame["play"] == tgame["play"]
        assert tgame["score"] == sum(m["points_earned"] for m in tgame["moves"])
    out = capsys.readouterr().out
    assert out.count("Demo assets exported to") == 2


def test_train_export_demo_writes_web_data(tmp_path, monkeypatch):
    """train --export-demo: at the end of the run, web/data holds the assets
    of the final model (the bytes an export of its train_state gives) and
    the run's best game."""
    monkeypatch.chdir(tmp_path)
    cli.main(["train", "--episodes", "4", "--batch-size", "32", "-H", "16",
              "--num-layers", "1", "--steps", "2", "--scan-cap", "60", "--points", "0.1",
              "--mono", "1.0", "--checkpoint-dir", "ck", "--export-demo", "--device", "cpu"])
    web = tmp_path / "web" / "data"
    assert {"best_game.json", *ASSETS} == {p.name for p in web.iterdir()}
    game = json.loads((web / "best_game.json").read_text())
    assert game["moves"] and game["score"] == sum(m["points_earned"] for m in game["moves"])
    model, cfg, mt = tload(tmp_path / "ck", "cpu")
    TEXP.export_demo_assets(model, cfg, mt, None, tmp_path / "again",
                            search_coefs=tcoefs(tmp_path / "ck"))
    assert_same_files(web, tmp_path / "again")
    coefs = json.loads((web / "model_config.json").read_text())["search_coefs"]
    assert coefs["points"] == 0.1 and coefs["mono"] == 1.0
