"""The port's optimizer (tpu2048_torch/ops/{muon,adamw,optimizer,schedules}.py)
against tpu2048.ops on the same parameters and gradients.

Tolerances: Newton-Schulz runs in bfloat16 on both sides with the same
rounding at every step; the matmuls accumulate in another order once the
inner dimension is large, so outputs are held to 2^-5 of the largest entry
(about 8 bfloat16 ulps at the top; measured: exact up to 64-wide, at most 4
ulps at 384). One combined step: 1e-4 absolute on parameters and state (a
bfloat16 difference in the orthogonalised update times Muon's adjusted lr).
The schedule: 1e-6 (both float32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_engine import one_torch_thread  # noqa: F401  (autouse)
from tpu2048.models import MLPConfig as JMLPConfig
from tpu2048.models import mlp as jmlp
from tpu2048.ops import muon as jmuon
from tpu2048.ops import optimizer as jopt
from tpu2048.ops import schedules as jsched
from tpu2048_torch.models.mlp import GameMLP, MLPConfig, param_labels
from tpu2048_torch.ops import muon as tmuon
from tpu2048_torch.ops import optimizer as topt
from tpu2048_torch.ops import schedules as tsched
from tpu2048_torch.train.checkpoint import key_path, params_to_state_dict


@pytest.mark.parametrize("shape", [(32, 32), (16, 48), (48, 16), (4, 384), (384, 48),
                                   (1, 384), (384, 384)])
def test_newton_schulz_matches_jax(shape):
    g = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
    want = np.asarray(jax.jit(jmuon.newton_schulz)(jnp.asarray(g)).astype(jnp.float32))
    got = tmuon.newton_schulz(torch.as_tensor(g))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0 ** -5 * np.abs(want).max())
    # A stack of same-shape matrices is orthogonalised matrix by matrix.
    stacked = tmuon.newton_schulz(torch.as_tensor(np.stack([g, 3 * g])))
    np.testing.assert_array_equal(stacked[0].float().numpy(), got.float().numpy())


def test_adjust_lr():
    for shape in ((384, 384), (4, 384), (384, 48)):
        assert np.isclose(float(tmuon.adjust_lr(np.float32(1e-3), shape)),
                          float(jmuon.adjust_lr(jnp.float32(1e-3), shape)), rtol=1e-7)
        assert np.isclose(float(tmuon.adjust_lr(np.float32(1e-3), shape, "original")),
                          float(jmuon.adjust_lr(jnp.float32(1e-3), shape, "original")))


@pytest.mark.parametrize("step", [0, 1, 5, 19, 20, 21, 500, 19999, 20000])
def test_cosine_with_warmup(step):
    want = float(jsched.cosine_with_warmup(jnp.int32(step), 20, 20000))
    got = tsched.cosine_with_warmup(step, 20, 20000)
    assert isinstance(got, np.float32)
    np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-6)


def _flat(tree) -> dict:
    """A JAX params-shaped tree as {dotted name: numpy array}."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in path)
        out[name] = np.asarray(leaf)
    return out


@pytest.fixture(scope="module")
def mlp_tree():
    cfg = JMLPConfig(hidden_dim=32, num_layers=2)
    params = jmlp.init(jax.random.key(1), cfg, zero_heads=False)
    model = GameMLP(MLPConfig(**cfg.to_dict()))
    model.load_state_dict(params_to_state_dict(jax.tree.map(np.asarray, params)))
    return params, model


@pytest.mark.parametrize("grad_scale,mult", [(0.01, 0.7), (50.0, 1.0)],
                         ids=["clip_off", "clip_on"])
def test_three_combined_steps_match_jax(mlp_tree, grad_scale, mult):
    """Routing by label, the global-norm clip (off at small gradients, on at
    large ones), the critic's own lr and the schedule multiplier, over three
    steps so that the momentum and AdamW moments are not trivial."""
    jparams, model = mlp_tree
    config = dict(learning_rate=1e-3, critic_lr=3e-4)
    jcfg, tcfg = jopt.OptimizerConfig(**config), topt.OptimizerConfig(**config)
    labels = jmlp.param_labels(jparams)
    jstate = jopt.init(jparams)
    tparams = {n: p.detach().clone() for n, p in model.named_parameters()}
    tstate = topt.init(tparams)
    tlabels = param_labels(model)
    rng = np.random.default_rng(7)
    jupdate = jax.jit(lambda g, s, p, m: jopt.update(g, s, p, labels, m, jcfg))
    for _ in range(3):
        grads = jax.tree.map(
            lambda p: jnp.asarray(rng.normal(0, grad_scale, p.shape).astype(np.float32)),
            jparams)
        jparams, jstate, jnorm = jupdate(grads, jstate, jparams, jnp.float32(mult))
        tnorm = topt.update_(tparams, {n: torch.tensor(v) for n, v in _flat(grads).items()},
                             tstate, tlabels, np.float32(mult), tcfg)
        np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-5)
    assert (float(jnorm) > 1.0) == (grad_scale > 1)
    for name, want in _flat(jparams).items():
        np.testing.assert_allclose(tparams[name].numpy(), want, rtol=0, atol=1e-4,
                                   err_msg=name)
    assert tstate.step == int(jstate.adamw.step) == 3
    for part, tree in ((tstate.momentum, jstate.muon.momentum), (tstate.m, jstate.adamw.m),
                       (tstate.v, jstate.adamw.v)):
        for name, want in _flat(tree).items():
            np.testing.assert_allclose(part[name].numpy(), want, rtol=1e-5, atol=1e-6,
                                       err_msg=name)
    # The layout: 1-D leaves keep a zero momentum, 2-D leaves zero AdamW moments.
    for name, p in tparams.items():
        untouched = tstate.momentum[name] if p.dim() == 1 else tstate.m[name]
        assert not untouched.any()


def test_zero_schedule_mult_leaves_parameters_bit_identical(mlp_tree):
    _, model = mlp_tree
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    before = {n: p.clone() for n, p in params.items()}
    state = topt.init(params)
    labels = param_labels(model)
    rng = np.random.default_rng(3)
    for _ in range(2):
        grads = {n: torch.as_tensor(rng.normal(0, 5, p.shape).astype(np.float32))
                 for n, p in params.items()}
        topt.update_(params, grads, state, labels, np.float32(0.0), topt.OptimizerConfig())
    for n in params:
        assert torch.equal(params[n], before[n]), n
    assert state.step == 2 and any(b.any() for b in state.momentum.values())


def test_state_round_trips_through_the_jax_layout(mlp_tree):
    jparams, model = mlp_tree
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = topt.init(params)
    rng = np.random.default_rng(4)
    for _ in range(2):
        topt.update_(params, {n: torch.as_tensor(rng.normal(size=p.shape).astype(np.float32))
                              for n, p in params.items()},
                     state, param_labels(model), np.float32(1.0), topt.OptimizerConfig())
    arrays = topt.state_to_arrays(state, key_path)
    # The JAX package's key paths of its optimizer state, leaf for leaf.
    jstate = jopt.init(jparams)
    want = {"['opt_state']" + jax.tree_util.keystr(p): np.asarray(v).dtype
            for p, v in jax.tree_util.tree_flatten_with_path(jstate)[0]}
    assert {k: v.dtype for k, v in arrays.items()} == want
    back = topt.state_from_arrays(arrays, list(params), key_path, "cpu")
    assert back.step == state.step == 2
    for part in ("momentum", "m", "v"):
        for n in params:
            assert torch.equal(getattr(back, part)[n], getattr(state, part)[n])
