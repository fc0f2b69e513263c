"""The port's checkpoint loader against tpu2048.train.evaluate's, on the
committed checkpoints and on one the JAX package writes."""

import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_engine import one_torch_thread  # noqa: F401  (autouse)
from tpu2048.algo.advantage import RtgMoments
from tpu2048.models import MLPConfig as JMLPConfig
from tpu2048.models import mlp as jmlp
from tpu2048.models import urm as jurm
from tpu2048.models.encoding import encode_boards as jencode
from tpu2048.ops import optimizer as jopt
from tpu2048.train import checkpoint as JCKPT
from tpu2048.train.evaluate import load_model_checkpoint as jload
from tpu2048.train.evaluate import load_search_coefs as jload_search_coefs
from tpu2048_torch import resolve_device
from tpu2048_torch.algo.search import SearchCoefs
from tpu2048_torch.models.encoding import encode_boards
from tpu2048_torch.models.urm import GameURM
from tpu2048_torch.train import checkpoint as TCKPT
from tpu2048_torch.train.evaluate import load_model_checkpoint as tload
from tpu2048_torch.train.evaluate import load_search_coefs

ROOT = Path(__file__).resolve().parent.parent


def _assert_same_weights(model, jparams):
    want = {".".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in p):
            np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    got = {k: v.numpy() for k, v in model.state_dict().items()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def train_state_dir(tmp_path_factory):
    """A directory holding only a train_state, written by the JAX package
    as its train loop writes one."""
    d = tmp_path_factory.mktemp("train_state_only")
    cfg = JMLPConfig(hidden_dim=24, num_layers=2, dropout=0.0)
    params = jmlp.init(jax.random.key(5), cfg, zero_heads=False)
    full = dict(params=params,
                opt_state=jopt.init(params, jmlp.param_labels(params)),
                moments=RtgMoments.initial(),
                key=jax.random.key_data(jax.random.key(0)))
    JCKPT.save_checkpoint(d, "train_state", arrays_tree=full,
                          manifest=dict(model_config=cfg.to_dict(),
                                        model_type="mlp", train_step=3))
    return d


@pytest.mark.parametrize("ckpt", ["checkpoints_expG", "checkpoints_ht"])
def test_committed_checkpoints_load_like_jax(ckpt):
    """expG is format v2 (key paths), ht is format v1 (leaf order)."""
    jparams, jcfg, jtype = jload(ROOT / ckpt)
    model, cfg, mtype = tload(ROOT / ckpt, device="cpu")
    assert cfg.to_dict() == jcfg.to_dict() and mtype == jtype == "mlp"
    _assert_same_weights(model, jparams)


def test_train_state_only_dir_loads_like_jax(train_state_dir):
    assert not TCKPT.checkpoint_exists(train_state_dir, "best_model")
    jparams, jcfg, _ = jload(train_state_dir)
    model, cfg, _ = tload(train_state_dir, device="cpu")
    assert cfg.to_dict() == jcfg.to_dict()
    _assert_same_weights(model, jparams)


def test_truncated_npz_raises(tmp_path):
    src = (ROOT / "checkpoints_expG" / "best_model.npz").read_bytes()
    (tmp_path / "best_model.npz").write_bytes(src[: len(src) // 2])
    (tmp_path / "best_model.json").write_text(
        (ROOT / "checkpoints_expG" / "best_model.json").read_text())
    with pytest.raises(JCKPT.CheckpointCorruptError):
        jload(tmp_path)
    with pytest.raises(TCKPT.CheckpointCorruptError, match="best_model.npz"):
        tload(tmp_path, device="cpu")


def test_structure_mismatch_names_the_parameter(tmp_path):
    cfg = JMLPConfig(hidden_dim=8, num_layers=1)
    params = jmlp.init(jax.random.key(0), cfg)
    params["extra"] = {"w": np.zeros((2,), np.float32)}
    JCKPT.save_checkpoint(tmp_path, "best_model", arrays_tree=dict(params=params),
                          manifest=dict(config=cfg.to_dict(), model_type="mlp"))
    with pytest.raises(ValueError, match="extra"):
        tload(tmp_path, device="cpu")


def test_urm_checkpoint_not_yet_ported():
    """checkpoints_urm_r5 builds a GameURM holding the JAX weights, whose
    forward matches ``urm.apply`` (tests/test_torch_urm.py holds it at more
    boards and its tolerance). The name dates from before the URM was
    ported, when this test pinned the loader's refusal."""
    jparams, jcfg, jtype = jload(ROOT / "checkpoints_urm_r5")
    model, cfg, mtype = tload(ROOT / "checkpoints_urm_r5", device="cpu")
    assert mtype == jtype == "urm" and isinstance(model, GameURM)
    assert cfg.to_dict() == jcfg.to_dict()
    _assert_same_weights(model, jparams)
    x = encode_boards(torch.as_tensor(np.zeros((2, 4, 4), np.int32)))
    want = jax.jit(lambda p, b: jurm.apply(p, jcfg, jencode(b)))(
        jparams, jnp.zeros((2, 4, 4), jnp.int32))
    with torch.inference_mode():
        got = model(x)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_embedded_manifest_only_best_model_loads(tmp_path):
    """A directory holding only ``best_model.npz`` (its manifest embedded, no
    ``.json`` mirror) loads in the port with the full directory's forward.
    The JAX loader opens the mirror and raises there."""
    shutil.copy(ROOT / "checkpoints_expG" / "best_model.npz", tmp_path)
    with pytest.raises(FileNotFoundError):
        jload(tmp_path)
    lone, cfg, _ = tload(tmp_path, device="cpu")
    full, full_cfg, _ = tload(ROOT / "checkpoints_expG", device="cpu")
    assert cfg == full_cfg and (cfg.hidden_dim, cfg.num_layers) == (384, 3)
    x = encode_boards(torch.as_tensor(
        np.random.default_rng(0).integers(0, 11, (64, 4, 4)).astype(np.int32)))
    with torch.inference_mode():
        for g, w in zip(lone(x), full(x)):
            np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_embedded_manifest_only_train_state_gives_calibrated_coefs(tmp_path):
    """``load_search_coefs`` on a directory whose ``train_state.npz`` embeds
    its manifest and has no ``.json`` mirror: the port reads the embedded
    manifest and gives the calibrated coefficients of the full directory.
    The JAX package reads only the mirror, so there it falls back to pure
    EV (``SearchCoefs()``) with its warning: a kept difference."""
    shutil.copy(ROOT / "checkpoints_expG" / "train_state.npz", tmp_path)
    got = load_search_coefs(tmp_path)
    assert tuple(got) == tuple(jload_search_coefs(ROOT / "checkpoints_expG"))
    assert got.sigma != 1.0 and got.mono > 0.0
    assert tuple(jload_search_coefs(tmp_path)) == tuple(SearchCoefs())


def test_missing_directory_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tload(tmp_path / "nope", device="cpu")


def test_cuda_without_a_card_raises():
    """Asking for cuda never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tload(ROOT / "checkpoints_expG")


def test_key_path_parsing():
    assert TCKPT.parse_key_path("['blocks'][0]['lin']['w']") == ("blocks", 0, "lin", "w")
    assert TCKPT.parse_key_path("['moments'].mu") == ("moments", "mu")
    with pytest.raises(ValueError):
        TCKPT.parse_key_path("blocks.0")
