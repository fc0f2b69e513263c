"""The port's encoding and GameMLP (tpu2048_torch/models) against the JAX
model on the same weights and inputs."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import random_board_np
from tests.test_torch_engine import one_torch_thread  # noqa: F401  (autouse)
from tpu2048.models import MLPConfig as JMLPConfig
from tpu2048.models import encoding as jencoding
from tpu2048.models import mlp as jmlp
from tpu2048.train.evaluate import load_model_checkpoint as jload
from tpu2048_torch.models import encoding as tencoding
from tpu2048_torch.models.mlp import GameMLP, MLPConfig
from tpu2048_torch.train.checkpoint import params_to_state_dict
from tpu2048_torch.train.evaluate import load_model_checkpoint as tload

# Float32 sums are taken in another order in the two frameworks (matmul
# blocking, layer-norm reductions), so outputs agree to f32 rounding, not
# bit for bit.
RTOL = ATOL = 1e-5

ROOT = Path(__file__).resolve().parent.parent


def _boards(seed, n):
    rng = np.random.default_rng(seed)
    return np.stack([random_board_np(rng) for _ in range(n)])


def test_encode_boards_bit_exact():
    boards = _boards(0, 64).reshape(4, 16, 4, 4)
    want = np.asarray(jencoding.encode_boards(jnp.asarray(boards)))
    got = tencoding.encode_boards(torch.as_tensor(boards))
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, 16, 48)
    np.testing.assert_array_equal(got.numpy(), want)


def _forward_both(jparams, jcfg, model, boards):
    enc = np.asarray(jencoding.encode_boards(jnp.asarray(boards)))
    jl, jv = jax.jit(lambda p, x: jmlp.apply(p, jcfg, x))(jparams, jnp.asarray(enc))
    with torch.no_grad():
        tl, tv = model(torch.tensor(enc))
    return (tl.numpy(), tv.numpy()), (np.asarray(jl), np.asarray(jv))


def test_flagship_forward_matches_jax():
    """checkpoints_expG (H=384x3) on 256 boards."""
    jparams, jcfg, _ = jload(ROOT / "checkpoints_expG")
    model, cfg, _ = tload(ROOT / "checkpoints_expG", device="cpu")
    assert (cfg.hidden_dim, cfg.num_layers) == (384, 3)
    assert not model.training
    got, want = _forward_both(jparams, jcfg, model, _boards(1, 256))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("form", ["nested", "key_path"])
def test_small_random_model_through_weight_carrier(form):
    """H=32, 2 blocks, decouple_critic, dropout on: random JAX weights
    (heads not zeroed) carried into the port, eval mode on both sides."""
    jcfg = JMLPConfig(hidden_dim=32, num_layers=2, dropout=0.1,
                      decouple_critic=True)
    jparams = jmlp.init(jax.random.key(3), jcfg, zero_heads=False)
    if form == "nested":
        carried = jax.tree.map(np.asarray, jparams)
    else:
        leaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
        carried = {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}
    model = GameMLP(MLPConfig(**jcfg.to_dict()))
    model.load_state_dict(params_to_state_dict(carried))
    model.eval()
    got, want = _forward_both(jparams, jcfg, model, _boards(2, 64))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_decouple_critic_detaches_value_features():
    torch.manual_seed(0)
    x = torch.randn(8, 48)
    for decouple, trunk_grad in ((True, False), (False, True)):
        model = GameMLP(MLPConfig(hidden_dim=16, num_layers=1,
                                  decouple_critic=decouple)).eval()
        _, value = model(x)
        value.sum().backward()
        assert model.value_head.w.grad is not None
        assert (model.stem.lin.w.grad is not None) == trunk_grad


def test_state_dict_names_are_jax_key_paths():
    model = GameMLP(MLPConfig(hidden_dim=8, num_layers=2))
    jparams = jmlp.init(jax.random.key(0), JMLPConfig(hidden_dim=8, num_layers=2))
    leaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    want = {".".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in p):
            tuple(v.shape) for p, v in leaves}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want


def test_fresh_mlp_zeroes_its_heads_as_mlp_init_does():
    """A fresh GameMLP: zero heads (as ``mlp.init(zero_heads=True)``),
    kaiming-relu weights within sqrt(6 / fan_in), zero biases, layer norms
    of gain 1 and bias 0; the first policy is uniform and the value 0."""
    cfg = MLPConfig(hidden_dim=32, num_layers=2)
    model = GameMLP(cfg, generator=torch.Generator().manual_seed(0))
    jparams = jmlp.init(jax.random.key(0), JMLPConfig(**cfg.to_dict()))
    for name, p in model.state_dict().items():
        if name.startswith(("action_head", "value_head")):
            assert not p.any(), name
            assert not np.asarray(jparams[name.split(".")[0]][name.split(".")[1]]).any()
        elif name.endswith("lin.w"):
            bound = np.sqrt(6.0 / p.shape[1])
            assert p.abs().max() <= bound and p.abs().max() > 0.9 * bound, name
            assert abs(float(p.mean())) < 0.1 * bound and float(p.std()) > 0.5 * bound, name
        elif name.endswith("ln.g"):
            assert torch.equal(p, torch.ones_like(p)), name
        else:
            assert name.endswith("ln.b") and not p.any(), name
    logits, value = model.eval()(tencoding.encode_boards(torch.as_tensor(_boards(3, 8))))
    assert not logits.any() and not value.any()
    live = GameMLP(cfg, zero_heads=False, generator=torch.Generator().manual_seed(0))
    assert live.action_head.w.any() and live.value_head.w.any()
    again = GameMLP(cfg, generator=torch.Generator().manual_seed(0))
    for (n, p), (_, q) in zip(model.named_parameters(), again.named_parameters()):
        assert torch.equal(p, q), n  # seeded: the same model again


def test_param_labels_equal_the_reference():
    from tpu2048_torch.models.mlp import param_labels

    jparams = jmlp.init(jax.random.key(0), JMLPConfig(hidden_dim=16, num_layers=3))
    leaves = jax.tree_util.tree_flatten_with_path(jmlp.param_labels(jparams))[0]
    want = {".".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in p): v
            for p, v in leaves}
    got = param_labels(GameMLP(MLPConfig(hidden_dim=16, num_layers=3)))
    assert got == want
    assert got["action_head.w"] == "muon_other" and got["value_head.w"] == "muon_value"
    assert got["value_head.b"] == "adamw_value" and got["stem.ln.g"] == "adamw_other"


def test_train_mode_dropout_draws_from_the_callers_generator():
    model = GameMLP(MLPConfig(hidden_dim=32, num_layers=2, dropout=0.5),
                    zero_heads=False, generator=torch.Generator().manual_seed(1))
    x = tencoding.encode_boards(torch.as_tensor(_boards(4, 16)))
    model.train()
    a, _ = model(x, torch.Generator().manual_seed(5))
    b, _ = model(x, torch.Generator().manual_seed(5))
    c, _ = model(x, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="generator"):
        model(x)
    model.eval()
    e1, _ = model(x)
    e2, _ = model(x, torch.Generator().manual_seed(6))
    assert torch.equal(e1, e2)  # eval mode: no dropout
