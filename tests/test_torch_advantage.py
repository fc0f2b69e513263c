"""The port's advantage pipeline (tpu2048_torch/algo/advantage.py) against
tpu2048.algo.advantage on seeded (T, N) chunks whose episodes end mid-chunk
and at the chunk boundary.

Tolerance: 1e-5 relative (atol 1e-5 times the quantity's scale). The port's
backward loop and the JAX package's parallel suffix scan (and its sequential
twin) add the same float32 terms in other orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_engine import one_torch_thread  # noqa: F401  (autouse)
from tpu2048.algo import advantage as JA
from tpu2048_torch.algo import advantage as TA

RTOL = 1e-5
T, N = 24, 16
WEIGHTS = dict(points=0.1, monotonicity=1.0, emptiness=0.5, smoothness=3.0)
GAMMA, RTG_BETA = 0.995, 0.99


def close(got, want):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL, atol=RTOL * scale)


@pytest.fixture(scope="module")
def chunk():
    rng = np.random.default_rng(0)
    done = rng.random((T, N)) < 0.08
    done[-1, :4] = True  # episodes that end exactly at the chunk boundary
    done[5, 4] = True  # and one mid-chunk in a lane that then runs on
    return dict(
        points=(rng.integers(0, 5, (T, N)) * 4 * (rng.random((T, N)) < 0.5)).astype(np.int32),
        mono_b=rng.integers(0, 40, (T, N)).astype(np.int32),
        mono_a=np.where(done, 0, rng.integers(0, 40, (T, N))).astype(np.int32),
        empt_b=rng.integers(0, 15, (T, N)).astype(np.int32),
        empt_a=np.where(done, 0, rng.integers(0, 15, (T, N))).astype(np.int32),
        value=rng.normal(size=(T, N)).astype(np.float32),
        valid=np.ones((T, N), bool),
        valid_cut=np.arange(T)[:, None] < rng.integers(3, T + 1, N)[None, :],
        done=done,
        boot=rng.normal(size=N).astype(np.float32),
        moments=(np.float32(2.9), np.float32(38.0), np.float32(2.9)),
    )


def _jw():
    return JA.RewardWeights(**WEIGHTS)


def _tw():
    return TA.RewardWeights(**WEIGHTS)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def test_step_rewards(chunk):
    c = chunk
    want = JA.step_rewards(*(jnp.asarray(c[k]) for k in ("points", "mono_b", "mono_a",
                                                           "empt_b", "empt_a")), _jw(), GAMMA)
    got = TA.step_rewards(*(_t(c[k]) for k in ("points", "mono_b", "mono_a", "empt_b",
                                               "empt_a")), _tw(), GAMMA)
    assert got.dtype == torch.float32
    close(got.numpy(), want)


@pytest.mark.parametrize("form", ["parallel", "sequential"])
def test_returns_to_go_packed(chunk, form):
    c = chunk
    rewards = np.random.default_rng(1).normal(size=(T, N)).astype(np.float32)
    jfn = JA.returns_to_go_packed if form == "parallel" else JA.returns_to_go_packed_sequential
    want = jax.jit(jfn, static_argnums=2)(jnp.asarray(rewards), jnp.asarray(c["done"]),
                                          GAMMA, jnp.asarray(c["boot"]))
    got = TA.returns_to_go_packed(_t(rewards), _t(c["done"]), GAMMA, _t(c["boot"]))
    close(got.numpy(), want)
    # A lane whose last step ended its episode never reads the bootstrap.
    assert np.allclose(got.numpy()[-1, :4], rewards[-1, :4])


@pytest.mark.parametrize("form", ["parallel", "sequential"])
def test_returns_to_go(chunk, form):
    rewards = np.random.default_rng(2).normal(size=(T, N)).astype(np.float32)
    jfn = JA.returns_to_go if form == "parallel" else JA.returns_to_go_sequential
    want = jax.jit(jfn, static_argnums=2)(jnp.asarray(rewards),
                                          jnp.asarray(chunk["valid_cut"]), GAMMA)
    close(TA.returns_to_go(_t(rewards), _t(chunk["valid_cut"]), GAMMA).numpy(), want)


def moments_after(step):
    """The moments after ``step`` EMA updates from the initial (0, 1) by
    batches of mean 3 and variance 25, as a run of ``step`` steps holds
    them (arbitrary moments can make m2/c - (mu/c)^2 cancel, and then any
    float32 rounding of beta^step is amplified)."""
    w = RTG_BETA ** step
    mu = (1 - w) * 3.0
    return tuple(np.float32(v) for v in (mu, w + (1 - w) * 34.0, mu))


@pytest.mark.parametrize("step", [1, 2, 37, 20000])
def test_normalize_rtg_and_corrected_moments(chunk, step):
    """Step 1 has the largest bias correction (1 - beta); the quirk's
    order (normalise with the old moments, then fold the batch in) holds."""
    G = np.random.default_rng(3).normal(3.0, 5.0, size=(T, N)).astype(np.float32)
    jm = JA.RtgMoments(*(jnp.asarray(v) for v in moments_after(step - 1)))
    tm = TA.RtgMoments(*(_t(v) for v in moments_after(step - 1)))
    want_mu, want_std = JA.corrected_mu_std(jm, RTG_BETA, jnp.int32(step))
    got_mu, got_std = TA.corrected_mu_std(tm, RTG_BETA, step)
    close(got_mu.numpy(), want_mu)
    close(got_std.numpy(), want_std)
    want = JA.normalize_rtg(jnp.asarray(G), jnp.asarray(chunk["valid_cut"]), jm,
                            RTG_BETA, jnp.int32(step))
    got = TA.normalize_rtg(_t(G), _t(chunk["valid_cut"]), tm, RTG_BETA, step)
    close(got[0].numpy(), want[0])
    for g, w in zip(got[1], want[1]):
        close(g.numpy(), w)
    close(got[2].numpy(), want[2])
    close(got[3].numpy(), want[3])


def test_initial_moments():
    for g, w in zip(TA.RtgMoments.initial(), JA.RtgMoments.initial()):
        assert g.dtype == torch.float32 and g.shape == ()
        assert float(g) == float(w)


@pytest.mark.parametrize("step", [1, 250])
def test_compute_packed(chunk, step):
    c = chunk
    jm = JA.RtgMoments(*(jnp.asarray(v) for v in c["moments"]))
    tm = TA.RtgMoments(*(_t(v) for v in c["moments"]))
    args = ("points", "mono_b", "mono_a", "empt_b", "empt_a", "value", "valid", "done", "boot")
    want = jax.jit(JA.compute_packed, static_argnums=(9, 10, 12))(
        *(jnp.asarray(c[k]) for k in args), _jw(), GAMMA, jm, RTG_BETA, jnp.int32(step))
    got = TA.compute_packed(*(_t(c[k]) for k in args), _tw(), GAMMA, tm, RTG_BETA, step)
    for k in ("reward", "G_raw", "G_norm", "advantage", "batch_mean", "batch_var"):
        close(got[k].numpy(), want[k])
    for g, w in zip(got["new_moments"], want["new_moments"]):
        close(g.numpy(), w)


def test_compute(chunk):
    c = chunk
    jm = JA.RtgMoments(*(jnp.asarray(v) for v in c["moments"]))
    tm = TA.RtgMoments(*(_t(v) for v in c["moments"]))
    args = ("points", "mono_b", "mono_a", "empt_b", "empt_a", "value", "valid_cut")
    want = jax.jit(JA.compute, static_argnums=(7, 8, 10))(
        *(jnp.asarray(c[k]) for k in args), _jw(), GAMMA, jm, RTG_BETA, jnp.int32(5))
    got = TA.compute(*(_t(c[k]) for k in args), _tw(), GAMMA, tm, RTG_BETA, 5)
    for k in ("reward", "G_raw", "G_norm", "advantage", "batch_mean", "batch_var"):
        close(got[k].numpy(), want[k])
    for g, w in zip(got["new_moments"], want["new_moments"]):
        close(g.numpy(), w)
