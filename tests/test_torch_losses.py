"""The port's PPO loss and KL diagnostic (tpu2048_torch/algo/losses.py)
against tpu2048.algo.losses: values, statistics and gradients.

Tolerance: 1e-5 (relative and absolute) on values and on the gradients with
respect to the logits and values (torch.autograd against jax.grad): float32
log-softmaxes and weighted means taken in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_engine import one_torch_thread  # noqa: F401  (autouse)
from tpu2048.algo import losses as JL
from tpu2048_torch.algo import losses as TL

TOL = 1e-5
B = 64


@pytest.fixture(scope="module")
def batch():
    """64 rows: 0 to 3 illegal actions each (so the -20 re-entry of the
    entropy is exercised), the taken action always legal, old logprobs
    that put some ratios above 1.2 and some below 0.8, advantages of both
    signs, a few rows of weight 0 and one padding row with no legal move."""
    rng = np.random.default_rng(0)
    mask = np.zeros((B, 4), bool)
    for i in range(B):
        mask[i, rng.choice(4, i % 4, replace=False)] = True
    mask[-1] = True  # padding row (weight 0)
    logits = rng.normal(0, 2, (B, 4)).astype(np.float32)
    legal_idx = [np.flatnonzero(~m) if (~m).any() else np.arange(4) for m in mask]
    targets = np.array([rng.choice(ix) for ix in legal_idx])
    old_logits = logits + rng.normal(0, 1.5, (B, 4)).astype(np.float32)
    masked = np.where(mask & ~mask.all(1, keepdims=True), -np.inf, old_logits)
    old_lp = (masked - np.log(np.exp(masked - masked.max(1, keepdims=True)).sum(1, keepdims=True))
              - masked.max(1, keepdims=True)).astype(np.float32)
    weights = (rng.random(B) > 0.1).astype(np.float32)
    weights[-1] = 0.0
    return dict(logits=logits, values=rng.normal(0, 2, (B, 1)).astype(np.float32),
                targets=targets.astype(np.int32), mask=mask,
                advantage=rng.normal(0, 1, B).astype(np.float32),
                rtg=rng.normal(0, 2, B).astype(np.float32),
                old_lp=old_lp, weights=weights)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL)


def test_batch_exercises_the_clip_on_both_sides(batch):
    lp = np.asarray(jax.nn.log_softmax(jnp.where(batch["mask"], -jnp.inf, batch["logits"])))
    i = np.arange(B - 1)
    ratio = np.exp(lp[i, batch["targets"][i]] - batch["old_lp"][i, batch["targets"][i]])
    assert (ratio > 1.2).sum() >= 5 and (ratio < 0.8).sum() >= 5


@pytest.mark.parametrize("denom", [None, 80.0])
def test_ppo_loss_value_stats_and_gradients(batch, denom):
    b = batch
    kw = dict(kl_strength=0.02, critic_strength=0.2)

    def jloss(logits, values):
        return JL.ppo_loss(logits, values, jnp.asarray(b["targets"]), jnp.asarray(b["mask"]),
                           jnp.asarray(b["advantage"]), jnp.asarray(b["rtg"]),
                           jnp.asarray(b["old_lp"]), jnp.asarray(b["weights"]),
                           denom=None if denom is None else jnp.float32(denom), **kw)

    (jl, jstats), (jg_logits, jg_values) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(b["logits"]), jnp.asarray(b["values"]))

    logits = torch.tensor(b["logits"], requires_grad=True)
    values = torch.tensor(b["values"], requires_grad=True)
    tl, tstats = TL.ppo_loss(
        logits, values, torch.as_tensor(b["targets"]), torch.as_tensor(b["mask"]),
        torch.as_tensor(b["advantage"]), torch.as_tensor(b["rtg"]),
        torch.as_tensor(b["old_lp"]), torch.as_tensor(b["weights"]),
        denom=None if denom is None else torch.tensor(denom), **kw)
    tg_logits, tg_values = torch.autograd.grad(tl, (logits, values))

    _close(tl.detach().numpy(), jl)
    for f in JL.LossStats._fields:
        _close(getattr(tstats, f).numpy(), getattr(jstats, f))
    assert np.isfinite(tg_logits.numpy()).all() and np.isfinite(tg_values.numpy()).all()
    _close(tg_logits.numpy(), jg_logits)
    _close(tg_values.numpy(), jg_values)
    # Illegal actions get no gradient.
    assert (tg_logits.numpy()[b["mask"] & ~b["mask"].all(1, keepdims=True)] == 0).all()


def test_smooth_l1():
    x = np.linspace(-3, 3, 61).astype(np.float32)
    _close(TL.smooth_l1(torch.as_tensor(x), torch.zeros(61)).numpy(),
           JL.smooth_l1(jnp.asarray(x), jnp.zeros(61)))


def test_kl_old_new(batch):
    b = batch
    new = b["logits"] + np.random.default_rng(5).normal(0, 0.3, (B, 4)).astype(np.float32)
    want = JL.kl_old_new(jnp.asarray(b["logits"]), jnp.asarray(new), jnp.asarray(b["mask"]),
                         jnp.asarray(b["weights"]))
    got = TL.kl_old_new(torch.as_tensor(b["logits"]), torch.as_tensor(new),
                        torch.as_tensor(b["mask"]), torch.as_tensor(b["weights"]))
    for g, w in zip(got, want):
        assert np.isfinite(g.numpy())
        _close(g.numpy(), w)
