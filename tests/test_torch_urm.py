"""The port's URM (tpu2048_torch/models/urm.py) against the JAX package's
``urm.apply`` on checkpoints_urm_r5, and its greedy play against the JAX
rollout."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import random_board_np
from tests.test_torch_evaluate import assert_greedy_loop_replays, jax_greedy_rollout
from tests.test_torch_engine import one_torch_thread  # noqa: F401  (autouse)
from tpu2048.models import URMConfig as JURMConfig
from tpu2048.models import urm as jurm
from tpu2048.models.encoding import encode_boards as jencode
from tpu2048.train.evaluate import load_model_checkpoint as jload
from tpu2048_torch.models.encoding import encode_boards
from tpu2048_torch.models.urm import GameURM, URMConfig
from tpu2048_torch.train.evaluate import load_model_checkpoint as tload

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "checkpoints_urm_r5"
# One block is a handful of float32 GEMMs, softmaxes and norms whose sums
# the two frameworks take in another order: 1e-5.
BLOCK_TOL = 1e-5
# The whole forward runs the two blocks 4 times over (8 blocks). Measured on
# this checkpoint, the recurrence multiplies a difference in the hidden state
# by about 2 per block in the last two loops: per-block differences of
# 2e-6 grow to 5e-5 in the logits (|logits| up to 7). Hence 1e-4.
FORWARD_TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    params, cfg, mtype = jload(CKPT)
    model, tcfg, ttype = tload(CKPT, device="cpu")
    assert mtype == ttype == "urm" and tcfg.to_dict() == cfg.to_dict()
    return params, cfg, model


def _boards(seed, n=256):
    rng = np.random.default_rng(seed)
    return np.stack([random_board_np(rng) for _ in range(n)])


def test_config_matches_jax():
    for kw in ({}, {"hidden_dim": 96, "expansion": 4.0, "conv_kernel": 3}):
        assert URMConfig(**kw).inter == JURMConfig(**kw).inter
        assert URMConfig(**kw).to_dict() == JURMConfig(**kw).to_dict()


def test_weights_carried_unchanged(models):
    params, _, model = models
    want = {".".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in p):
            np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    got = {k: v.numpy() for k, v in model.state_dict().items()}
    assert got.keys() == want.keys()
    assert got["init_hidden"].shape == (1, 16, 64)
    assert got["blocks.0.dwconv.w"].shape == (model.config.inter, 2)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("part", ["attention", "conv_swiglu", "block"])
def test_block_parts_match_jax(models, part):
    params, cfg, model = models
    x = np.random.default_rng(0).normal(size=(64, 16, 64)).astype(np.float32)
    jfn = {"attention": lambda p, h: jurm._attention(p, h, cfg, train=False, rng=None),
           "conv_swiglu": lambda p, h: jurm._conv_swiglu(p, h, cfg),
           "block": lambda p, h: jurm._block(p, h, cfg, train=False, rng=None)}[part]
    tfn = getattr(model, f"_{part}")
    for i in range(cfg.num_layers):
        want = np.asarray(jax.jit(jfn)(params["blocks"][i], jnp.asarray(x)))
        with torch.no_grad():
            got = tfn(model.blocks[i], torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=BLOCK_TOL, atol=BLOCK_TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_jax(models, seed):
    params, cfg, model = models
    boards = _boards(seed)
    want = jax.jit(lambda p, x: jurm.apply(p, cfg, x))(params, jencode(jnp.asarray(boards)))
    with torch.inference_mode():
        got = model(encode_boards(torch.as_tensor(boards)))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=FORWARD_TOL,
                                   atol=FORWARD_TOL)


def test_single_board_input(models):
    _, _, model = models
    x = encode_boards(torch.as_tensor(_boards(2, 3)))
    with torch.inference_mode():
        one = model(x[1])
        many = model(x)
    assert one[0].shape == (1, 4) and one[1].shape == (1, 1)
    np.testing.assert_allclose(one[0].numpy(), many[0][1:2].numpy(), rtol=1e-6, atol=1e-6)


def test_truncated_loops_carry_no_gradient():
    torch.manual_seed(0)
    cfg = URMConfig(hidden_dim=16, num_heads=2, num_loops=2, num_truncated_loops=1)
    model = GameURM(cfg)
    for q in model.parameters():
        torch.nn.init.normal_(q, std=0.2)
    model(encode_boards(torch.as_tensor(_boards(3, 4))))[1].sum().backward()
    assert model.init_hidden.grad is None  # only the first loop reads it
    assert model.blocks[0]["qkv"].w.grad.abs().sum() > 0


def test_greedy_loop_replays_jax_urm_rollout(models):
    _, _, model = models
    games, steps = 8, 100
    assert_greedy_loop_replays(model, jax_greedy_rollout("checkpoints_urm_r5", games, steps),
                               games, steps)
