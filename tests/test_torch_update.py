"""The port's learner (tpu2048_torch/algo/update.py::make_optimize_fn), given
the JAX package's permutation draws and augmentation plan, against
tpu2048.algo.update.make_optimize_fn on the same dataset and parameters:
two epochs of a lazily augmented dataset whose last window is clamped and
partly weighted, with the KL diagnostic on and off.

Tolerances, after 8 minibatch steps: num_batches exact. The loss, policy,
value and entropy statistics and the gradient norm 2e-4 relative: each is
taken before its minibatch's step, so it sees the batch composition and
weights exactly, and only float32 order differs. The KL statistics 1e-2
relative: a KL of nearly equal distributions is a difference of close
logprobs. Parameters 5e-4 absolute, about half of one Muon step here
(adjusted lr 1.1e-3): the gradients' float32 differences (3e-8 after one
step) flip bfloat16 roundings inside Newton-Schulz, and in the action
head's near-null direction (its gradient's rows sum to zero) the output is
rounding noise in both frameworks. One minibatch alone agrees to 3e-8.
The plan's own draws are checked separately."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import random_board_np
from tests.test_torch_engine import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_optim import _flat
from tpu2048.algo import update as JU
from tpu2048.env import engine as jengine
from tpu2048.models import MLPConfig as JMLPConfig
from tpu2048.models import mlp as jmlp
from tpu2048.ops import optimizer as jopt
from tpu2048_torch.algo import augment as TAUG
from tpu2048_torch.algo import update as TU
from tpu2048_torch.models.mlp import GameMLP, MLPConfig, param_labels
from tpu2048_torch.ops import optimizer as topt
from tpu2048_torch.train.checkpoint import params_to_state_dict

S_REAL, A, BATCH, EPOCHS = 128, 72, 64, 2
S_CAP = S_REAL + A  # 200
PARAM_TOL = 5e-4
STAT_TOL = 2e-4
KL_TOL = 1e-2


@pytest.fixture(scope="module")
def data():
    """125 of 128 real rows valid, 70 of 72 augmented rows: S = 195 of
    S_cap = 200, so ceil(195/64) = 4 minibatches an epoch and the last
    window (logical start 192) is clamped to start 136, of whose 64 rows
    only the 3 at positions 192-194 carry weight."""
    rng = np.random.default_rng(0)
    boards = np.stack([random_board_np(rng, max_exp=9) for _ in range(S_REAL)])
    mask = ~np.asarray(jengine.all_moves(jnp.asarray(boards)).legal).T
    mask[mask.all(1)] = False
    action = np.array([rng.choice(np.flatnonzero(~m)) for m in mask])
    logits = rng.normal(0, 1, (S_REAL, 4))
    logits = np.where(mask, -np.inf, logits)
    logprobs = (logits - np.log(np.exp(logits).sum(1, keepdims=True))).astype(np.float32)
    valid = np.ones(S_CAP, bool)
    valid[[3, 50, 90]] = False
    valid[S_REAL + np.array([7, 40])] = False
    return dict(board=boards.astype(np.int8), action=action.astype(np.int32), mask=mask,
                advantage=rng.normal(0, 1, S_REAL).astype(np.float32),
                G_norm=rng.normal(0, 1, S_REAL).astype(np.float32), logprobs=logprobs,
                valid=valid, aug_src=rng.integers(0, S_REAL, A).astype(np.int32),
                aug_tf=rng.integers(0, 6, A).astype(np.int32))


def jax_perm_draws(key):
    """The uniform draws of each epoch's shuffle, as the JAX optimize takes
    them from its key."""
    draws = []
    for _ in range(EPOCHS):
        k_perm, _, key = jax.random.split(key, 3)
        draws.append(np.asarray(jax.random.uniform(k_perm, (S_CAP,))))
    return np.stack(draws)


@pytest.mark.parametrize("kl_diagnostic", [True, False], ids=["kl_on", "kl_off"])
def test_optimize_matches_jax(data, kl_diagnostic):
    d = data
    cfg = JMLPConfig(hidden_dim=32, num_layers=2, dropout=0.0)
    params = jmlp.init(jax.random.key(2), cfg, zero_heads=False)
    labels = jmlp.param_labels(params)
    ocfg = dict(learning_rate=1e-3, critic_lr=3e-4)
    joptimize = JU.make_optimize_fn(
        lambda p, x, rng: jmlp.apply(p, cfg, x, train=True, rng=rng), labels,
        jopt.OptimizerConfig(**ocfg), BATCH, EPOCHS, kl_diagnostic=kl_diagnostic)
    jds = JU.Dataset(board_before=jnp.asarray(d["board"]), action=jnp.asarray(d["action"]),
                     action_mask=jnp.asarray(d["mask"]), advantage=jnp.asarray(d["advantage"]),
                     G_norm=jnp.asarray(d["G_norm"]), logprobs=jnp.asarray(d["logprobs"]),
                     target_probs=jnp.zeros((S_REAL, 4)), valid=jnp.asarray(d["valid"]),
                     aug_src=jnp.asarray(d["aug_src"]), aug_tf=jnp.asarray(d["aug_tf"]))
    key = jax.random.key(5)
    jparams, jstate, jstats = jax.jit(joptimize)(params, jopt.init(params), jds, key,
                                                 jnp.float32(0.02), 0.2, jnp.float32(1.0))

    model = GameMLP(MLPConfig(**cfg.to_dict()))
    model.load_state_dict(params_to_state_dict(jax.tree.map(np.asarray, params)))
    model.eval()
    toptimize = TU.make_optimize_fn(model, param_labels(model), topt.OptimizerConfig(**ocfg),
                                    BATCH, EPOCHS, kl_diagnostic=kl_diagnostic)
    t = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    tds = TU.Dataset(board_before=t(d["board"]), action=t(d["action"]), action_mask=t(d["mask"]),
                     advantage=t(d["advantage"]), G_norm=t(d["G_norm"]),
                     logprobs=t(d["logprobs"]), valid=t(d["valid"]), aug_src=t(d["aug_src"]),
                     aug_tf=t(d["aug_tf"]))
    state = topt.init(dict(model.named_parameters()))
    tstats = toptimize(state, tds, 0.02, 0.2, np.float32(1.0),
                       perm_draws=t(jax_perm_draws(key)))

    assert float(tstats.num_batches) == float(jstats.num_batches) == 4 * EPOCHS
    assert state.step == int(jstate.adamw.step) == 4 * EPOCHS
    for f in TU.OptimizeStats._fields:
        want = float(getattr(jstats, f))
        tol = KL_TOL if f.startswith("kl_") else STAT_TOL
        np.testing.assert_allclose(float(getattr(tstats, f)), want, rtol=tol, atol=0,
                                   err_msg=f)
    if kl_diagnostic:
        assert float(tstats.kl_max) > 0
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    for name, want in _flat(jparams).items():
        np.testing.assert_allclose(got[name], want, rtol=0, atol=PARAM_TOL, err_msg=name)
        assert not np.array_equal(want, np.asarray(_flat(params)[name])), name


def test_dataset_smaller_than_a_minibatch_trains_as_one(data):
    """S_cap < batch_size: one shorter minibatch over the valid rows."""
    d = data
    model = GameMLP(MLPConfig(hidden_dim=16, num_layers=1, dropout=0.0), zero_heads=False,
                    generator=torch.Generator().manual_seed(0)).eval()
    t = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    ds = TU.Dataset(board_before=t(d["board"]), action=t(d["action"]),
                    action_mask=t(d["mask"]), advantage=t(d["advantage"]),
                    G_norm=t(d["G_norm"]), logprobs=t(d["logprobs"]),
                    valid=t(d["valid"][:S_REAL]))
    state = topt.init(dict(model.named_parameters()))
    stats = TU.make_optimize_fn(model, param_labels(model), topt.OptimizerConfig(), 4096, 1)(
        state, ds, 0.02, 0.2, np.float32(1.0), perm_generator=torch.Generator().manual_seed(1))
    assert float(stats.num_batches) == 1 and state.step == 1
    assert all(np.isfinite(float(v)) for v in stats)


def test_plan_draws_sources_among_valid_rows():
    """Sources uniform among the valid rows (with replacement); about half of
    each kind of candidate kept; mirrors are ids 1-2, rotations 3-5; only
    the first num_to_sample slots are used."""
    flat_valid = torch.ones(4000, dtype=torch.bool)
    flat_valid[::3] = False
    p = TAUG.plan(torch.Generator().manual_seed(0), 3000, torch.tensor(2500), flat_valid)
    assert p.src.shape == p.transform.shape == p.valid.shape == (6000,)
    assert torch.equal(p.src[:3000], p.src[3000:])
    assert flat_valid[p.src].all()
    assert set(p.transform[:3000].tolist()) == {1, 2}
    assert set(p.transform[3000:].tolist()) == {3, 4, 5}
    assert not p.valid[2500:3000].any() and not p.valid[5500:].any()
    kept = p.valid.view(2, 3000)[:, :2500].float().mean(1)
    assert ((kept > 0.45) & (kept < 0.55)).all()
    counts = np.bincount(p.src[:3000].numpy() % 3, minlength=3)
    assert counts[0] == 0 and abs(counts[1] - counts[2]) < 200


def test_urm_optimize_matches_jax(data):
    """The same learner call with a small URM (3 loops, the first truncated)
    at dropout 0: two epochs of the lazily augmented dataset, KL diagnostic
    on. Muon takes every strictly 2-D weight (the depthwise conv's (inter, k)
    included), AdamW the 3-D init_hidden, the biases and the norms.
    Tolerances as for the MLP: statistics 2e-4 relative, KL 1e-2,
    parameters 5e-4 absolute (bfloat16 Newton-Schulz over 8 steps)."""
    from tpu2048.models import URMConfig as JURMConfig
    from tpu2048.models import urm as jurm
    from tpu2048_torch.models import urm as turm

    d = data
    cfg = JURMConfig(hidden_dim=16, num_layers=2, num_heads=2, num_loops=3,
                     num_truncated_loops=1, dropout=0.0)
    params = jurm.init(jax.random.key(2), cfg, zero_heads=False)
    labels = jurm.param_labels(params)
    ocfg = dict(learning_rate=1e-3, critic_lr=3e-4)
    joptimize = JU.make_optimize_fn(
        lambda p, x, rng: jurm.apply(p, cfg, x, train=True, rng=rng), labels,
        jopt.OptimizerConfig(**ocfg), BATCH, EPOCHS, kl_diagnostic=True)
    jds = JU.Dataset(board_before=jnp.asarray(d["board"]), action=jnp.asarray(d["action"]),
                     action_mask=jnp.asarray(d["mask"]), advantage=jnp.asarray(d["advantage"]),
                     G_norm=jnp.asarray(d["G_norm"]), logprobs=jnp.asarray(d["logprobs"]),
                     target_probs=jnp.zeros((S_REAL, 4)), valid=jnp.asarray(d["valid"]),
                     aug_src=jnp.asarray(d["aug_src"]), aug_tf=jnp.asarray(d["aug_tf"]))
    key = jax.random.key(5)
    jparams, jstate, jstats = jax.jit(joptimize)(params, jopt.init(params), jds, key,
                                                 jnp.float32(0.02), 0.2, jnp.float32(1.0))

    model = turm.GameURM(turm.URMConfig(**cfg.to_dict()))
    model.load_state_dict(params_to_state_dict(jax.tree.map(np.asarray, params)))
    model.eval()
    toptimize = TU.make_optimize_fn(model, turm.param_labels(model),
                                    topt.OptimizerConfig(**ocfg), BATCH, EPOCHS)
    t = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    tds = TU.Dataset(board_before=t(d["board"]), action=t(d["action"]), action_mask=t(d["mask"]),
                     advantage=t(d["advantage"]), G_norm=t(d["G_norm"]),
                     logprobs=t(d["logprobs"]), valid=t(d["valid"]), aug_src=t(d["aug_src"]),
                     aug_tf=t(d["aug_tf"]))
    state = topt.init(dict(model.named_parameters()))
    tstats = toptimize(state, tds, 0.02, 0.2, np.float32(1.0),
                       perm_draws=t(jax_perm_draws(key)))

    assert float(tstats.num_batches) == float(jstats.num_batches) == 4 * EPOCHS
    for f in TU.OptimizeStats._fields:
        tol = KL_TOL if f.startswith("kl_") else STAT_TOL
        np.testing.assert_allclose(float(getattr(tstats, f)), float(getattr(jstats, f)),
                                   rtol=tol, atol=0, err_msg=f)
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    want = _flat(jparams)
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=PARAM_TOL, err_msg=name)
        # Every leaf moves; init_hidden by weight decay and AdamW's zero-
        # gradient step alone.
        assert not np.array_equal(w, np.asarray(_flat(params)[name])), name
    np.testing.assert_array_equal(state.m["init_hidden"].numpy(), 0)
