"""Expert iteration in the port against tpu2048: the imitation objective
(tpu2048_torch/algo/losses.py::imitation_loss), the live search coefs
(algo/search.py::coefs_from_moments), the exact rollout's expert branch
(algo/rollout.py::rollout) and the learner's imitation objectives and
anchor-KL trust region (algo/update.py::make_optimize_fn), each fed the
same seeded numpy inputs as the JAX function.

Tolerances: the loss, its four statistics and its gradient with respect to
the logits 1e-6 (float32 log-softmaxes and weighted means in another
order); coefs 1e-6 relative; the rollout's integer and boolean records, its
episode summaries and its trip count bit-exact, its float records
(logprobs, value_pred, entropy) 1e-5 and target_probs 1e-4: a softmax of
scores / (sigma * tau), so the scores' float32 rounding (a few ulp of
|score|, summed in another order) is multiplied by |score| / (sigma * tau),
about 75 in the live-teacher step of tests/test_torch_expert_train.py (a
measured 1.4e-5 there); the learner as
tests/test_torch_update.py states (statistics 2e-4 relative, KL 1e-2,
parameters 5e-4 absolute after 8 minibatch steps)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_engine import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_optim import _flat
from tests.test_torch_rollout_exact import injected, port_model
from tests.test_torch_update import (BATCH, EPOCHS, KL_TOL, PARAM_TOL, S_REAL,
                                     STAT_TOL, jax_perm_draws)
from tests.test_torch_update import data  # noqa: F401  (fixture)
from tpu2048.algo import advantage as JA
from tpu2048.algo import losses as JL
from tpu2048.algo import rollout as JR
from tpu2048.algo import search as JS
from tpu2048.algo import update as JU
from tpu2048.models import MLPConfig as JMLPConfig
from tpu2048.models import mlp as jmlp
from tpu2048.ops import optimizer as jopt
from tpu2048_torch.algo import advantage as TA
from tpu2048_torch.algo import losses as TL
from tpu2048_torch.algo import rollout as TR
from tpu2048_torch.algo import search as TS
from tpu2048_torch.algo import update as TU
from tpu2048_torch.models.mlp import param_labels
from tpu2048_torch.ops import optimizer as topt

LOSS_TOL = 1e-6
FLOAT_TOL = 1e-5
TARGET_PROBS_TOL = 1e-4
B = 64


# --- imitation_loss -------------------------------------------------------


@pytest.fixture(scope="module")
def batch():
    """64 rows with 0 to 3 illegal actions each and one padding row with none
    legal (weight 0): soft targets zero on the illegal actions, some rows
    with an exact tie at the top of q (gap 0) and some one-hot rows."""
    rng = np.random.default_rng(1)
    mask = np.zeros((B, 4), bool)
    for i in range(B):
        mask[i, rng.choice(4, i % 4, replace=False)] = True
    mask[-1] = True
    z = rng.normal(0, 2, (B, 4))
    q = np.where(mask, 0.0, np.exp(z - z.max(1, keepdims=True)))
    q[:-1] /= q[:-1].sum(1, keepdims=True)
    for i in range(0, B - 1, 9):  # ties between the two best legal actions
        legal = np.flatnonzero(~mask[i])
        if len(legal) >= 2:
            q[i] = 0.0
            q[i, legal[:2]] = 0.5
    for i in range(5, B - 1, 13):  # one-hot rows (gap 1)
        q[i] = 0.0
        q[i, np.flatnonzero(~mask[i])[-1]] = 1.0
    legal_idx = [np.flatnonzero(~m) if (~m).any() else np.arange(4) for m in mask]
    weights = (rng.random(B) > 0.1).astype(np.float32)
    weights[-1] = 0.0
    return dict(logits=rng.normal(0, 2, (B, 4)).astype(np.float32),
                values=rng.normal(0, 2, (B, 1)).astype(np.float32),
                targets=np.array([rng.choice(ix) for ix in legal_idx], np.int32),
                mask=mask, advantage=rng.normal(0, 1, B).astype(np.float32),
                rtg=rng.normal(0, 2, B).astype(np.float32),
                old_lp=rng.normal(-1.4, 0.3, (B, 4)).astype(np.float32),
                weights=weights, q=q.astype(np.float32))


@pytest.mark.parametrize("target,sharp", [("soft", False), ("soft", True), ("one_hot", False),
                                          ("one_hot", True)])
def test_imitation_loss_value_stats_and_gradient(batch, target, sharp):
    b = batch
    q = b["q"] if target == "soft" else None
    kw = dict(kl_strength=0.02, critic_strength=0.2)

    def jloss(logits, values):
        return JL.imitation_loss(
            logits, values, jnp.asarray(b["targets"]), jnp.asarray(b["mask"]),
            jnp.asarray(b["advantage"]), jnp.asarray(b["rtg"]), jnp.asarray(b["old_lp"]),
            jnp.asarray(b["weights"]), target_probs=None if q is None else jnp.asarray(q),
            sharp=sharp, **kw)

    (jl, jstats), (jg, jgv) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(b["logits"]), jnp.asarray(b["values"]))
    logits = torch.tensor(b["logits"], requires_grad=True)
    values = torch.tensor(b["values"], requires_grad=True)
    tl, tstats = TL.imitation_loss(
        logits, values, torch.as_tensor(b["targets"]), torch.as_tensor(b["mask"]),
        torch.as_tensor(b["advantage"]), torch.as_tensor(b["rtg"]),
        torch.as_tensor(b["old_lp"]), torch.as_tensor(b["weights"]),
        target_probs=None if q is None else torch.as_tensor(q), sharp=sharp, **kw)
    tg, tgv = torch.autograd.grad(tl, (logits, values))
    np.testing.assert_allclose(tl.detach().numpy(), jl, rtol=LOSS_TOL, atol=LOSS_TOL)
    for f in JL.LossStats._fields:
        np.testing.assert_allclose(getattr(tstats, f).numpy(), getattr(jstats, f),
                                   rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=f)
    assert np.isfinite(tg.numpy()).all()
    np.testing.assert_allclose(tg.numpy(), jg, rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(tgv.numpy(), jgv, rtol=LOSS_TOL, atol=LOSS_TOL)
    # Tied rows (gap 0) and illegal actions get no policy gradient, and the
    # policy term is not zero overall.
    assert float(tstats.policy_loss) != 0.0
    tied = np.flatnonzero(np.sort(b["q"], 1)[:, -1] == np.sort(b["q"], 1)[:, -2])
    if q is not None:
        pure_entropy = TL.imitation_loss(
            logits, values, torch.as_tensor(b["targets"]), torch.as_tensor(b["mask"]),
            torch.as_tensor(b["advantage"]), torch.as_tensor(b["rtg"]),
            torch.as_tensor(b["old_lp"]), torch.as_tensor(b["weights"]),
            target_probs=torch.zeros(B, 4), sharp=sharp, **kw)[0]
        g0 = torch.autograd.grad(pure_entropy, logits)[0]
        np.testing.assert_allclose(tg.numpy()[tied], g0.numpy()[tied], rtol=0, atol=1e-7)
    assert (tg.numpy()[b["mask"] & ~b["mask"].all(1, keepdims=True)] == 0).all()


def test_ppo_loss_ignores_target_probs(batch):
    b = batch
    args = [torch.as_tensor(b[k]) for k in ("logits", "values", "targets", "mask",
                                            "advantage", "rtg", "old_lp", "weights")]
    kw = dict(kl_strength=0.02, critic_strength=0.2)
    with_q, _ = TL.ppo_loss(*args, target_probs=torch.as_tensor(b["q"]), **kw)
    assert torch.equal(with_q, TL.ppo_loss(*args, **kw)[0])


# --- coefs_from_moments ---------------------------------------------------


@pytest.mark.parametrize("rtg_step", [0, 1, 10_000])
def test_coefs_from_moments(rtg_step):
    mu, m2 = 31.7, 2650.0  # m2 > mu^2: a real spread
    want = JS.coefs_from_moments(JA.RtgMoments(jnp.float32(mu), jnp.float32(m2),
                                               jnp.float32(mu)),
                                 jnp.int32(rtg_step), 0.1, 1.0, 0.0, 0.995, 0.9)
    moments = TA.RtgMoments(*(torch.tensor(v, dtype=torch.float32) for v in (mu, m2, mu)))
    got = TS.coefs_from_moments(moments, rtg_step, 0.1, 1.0, 0.0, 0.995, 0.9)
    for f in ("points", "mono", "empt", "gamma"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("sigma", "mu"):
        v = getattr(got, f)
        assert isinstance(v, torch.Tensor) and v.dim() == 0, f
        np.testing.assert_allclose(float(v), float(getattr(want, f)), rtol=LOSS_TOL, err_msg=f)
    # The variance floor: a degenerate spread gives sigma 1e-4 in both.
    flat = TS.coefs_from_moments(TA.RtgMoments(*(torch.tensor(v) for v in (2.0, 4.0, 2.0))),
                                 1, 0.1, 1.0, 0.0, 0.995, 0.9)
    np.testing.assert_allclose(float(flat.sigma), 1e-4, rtol=1e-3)


def test_search_takes_tensor_coefs():
    """expectimax_scores with 0-d tensor sigma/mu equals it with the same
    Python floats."""
    model = port_model(jmlp.init(jax.random.key(0), JMLPConfig(hidden_dim=16, num_layers=1),
                                 zero_heads=False), JMLPConfig(hidden_dim=16, num_layers=1))
    boards = torch.as_tensor(np.random.default_rng(2).integers(0, 6, (3, 4, 4)), dtype=torch.int32)
    floats = TS.SearchCoefs(0.1, 0.7, 0.3, 2.5, -0.4, 0.97)
    tensors = floats._replace(sigma=torch.tensor(2.5), mu=torch.tensor(-0.4))
    with torch.no_grad():
        a = TS.expectimax_scores(model, boards, None, floats, 1)
        b = TS.expectimax_scores(model, boards, None, tensors, 1)
    assert torch.equal(a, b)


# --- the expert rollout ---------------------------------------------------

STUDENT = JMLPConfig(hidden_dim=32, num_layers=2)
TEACHER = JMLPConfig(hidden_dim=24, num_layers=1)
COEFS = dict(points=0.1, mono=0.7, empt=0.3, sigma=2.5, mu=-0.4, gamma=0.97)
# depth, games, cap, mix, tau, frozen teacher, bf16 leaves
CASES = {
    "d1_mix1_onehot_live": (1, 4, 40, 1.0, 0.0, False, False),
    "d1_mix05_soft_frozen": (1, 4, 40, 0.5, 0.05, True, False),
    "d1_mix0_soft_frozen_bf16": (1, 3, 40, 0.0, 0.05, True, True),
    "d1_mix05_soft_live_bf16": (1, 4, 40, 0.5, 0.05, False, True),
    "d2_mix05_soft_frozen_bf16": (2, 2, 4, 0.5, 0.05, True, True),
    "d2_mix0_onehot_live": (2, 2, 3, 0.0, 0.0, False, False),
}
INT_FIELDS = ("board_before", "board_after", "action", "target_action", "action_mask",
              "points", "preview", "max_created", "mono_before", "mono_after",
              "empt_before", "empt_after", "valid", "done_here")


@pytest.fixture(scope="module")
def nets():
    return (jmlp.init(jax.random.key(3), STUDENT, zero_heads=False),
            jmlp.init(jax.random.key(8), TEACHER, zero_heads=False))


def jax_expert_rollout(student, teacher, case, seed=11):
    depth, games, cap, mix, tau, frozen, bf16 = case
    kw = dict(expert_depth=depth, expert_coefs=JS.SearchCoefs(**COEFS), expert_mix=mix,
              expert_tau=tau, expert_bf16=bf16)
    if frozen:
        kw.update(expert_apply=lambda q, x: jmlp.apply(q, TEACHER, x), expert_params=teacher)
    go = jax.jit(lambda p, k: JR.rollout(lambda q, x: jmlp.apply(q, STUDENT, x), p, k,
                                         games, cap, **kw))
    return jax.tree.map(np.asarray, go(student, jax.random.key(seed)))


def port_expert_rollout(student, teacher, case, jtraj):
    depth, games, cap, mix, tau, frozen, bf16 = case
    boards, actions, spawns = injected(jtraj, games, cap)
    return TR.rollout(port_model(student, STUDENT), games, cap, boards=boards,
                      actions=actions, spawns=spawns, expert_depth=depth,
                      expert_coefs=TS.SearchCoefs(**COEFS), expert_mix=mix, expert_tau=tau,
                      expert_model=port_model(teacher, TEACHER) if frozen else None,
                      expert_bf16=bf16)


def assert_replays(ttraj, jtraj):
    assert ttraj.steps_executed == int(jtraj.steps_executed)
    for name in TR.Trajectory._fields[:-1]:
        got, want = getattr(ttraj, name).numpy(), getattr(jtraj, name)
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if name in INT_FIELDS or want.dtype != np.float32:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            tol = TARGET_PROBS_TOL if name == "target_probs" else FLOAT_TOL
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_expert_rollout_replays_jax(nets, name):
    case = CASES[name]
    depth, games, cap, mix, tau, frozen, bf16 = case
    jtraj = jax_expert_rollout(*nets, case)
    ttraj = port_expert_rollout(*nets, case, jtraj)
    assert_replays(ttraj, jtraj)
    valid = jtraj.valid
    n_expert = int(round(mix * games))
    took = jtraj.action == jtraj.target_action
    assert took[:, :n_expert][valid[:, :n_expert]].all()
    probs = jtraj.target_probs[valid]
    legal = ~jtraj.action_mask[valid]
    assert (probs[~legal] == 0).all()
    np.testing.assert_allclose(probs.sum(1)[legal.any(1)], 1.0, rtol=1e-6)
    if tau > 0:
        assert ((probs > 0) & (probs < 1)).any()  # soft, not one-hot
    if 0 < n_expert < games:  # the policy envs sampled, not always the expert's move
        assert not took[:, n_expert:][valid[:, n_expert:]].all()


def test_expert_only_rollout_draws_no_action(nets):
    """mix 1.0: every env takes the expert's move and the action generator
    is left as it was (a resumed run's streams stay aligned)."""
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    traj = TR.rollout(port_model(nets[0], STUDENT), 3, 8, action_generator=gen,
                      env_generator=torch.Generator().manual_seed(6), expert_depth=1,
                      expert_coefs=TS.SearchCoefs(**COEFS), expert_mix=1.0)
    assert torch.equal(gen.get_state(), state)
    assert torch.equal(traj.action, traj.target_action) and traj.valid.any()
    TR.rollout(port_model(nets[0], STUDENT), 3, 8, action_generator=gen,
               env_generator=torch.Generator().manual_seed(6), expert_depth=1,
               expert_coefs=TS.SearchCoefs(**COEFS), expert_mix=0.5)
    assert not torch.equal(gen.get_state(), state)


def test_expert_rollout_refuses_a_teacher_in_train_mode(nets):
    teacher = port_model(nets[1], TEACHER).train()
    with pytest.raises(ValueError, match="eval mode"):
        TR.rollout(port_model(nets[0], STUDENT), 2, 4, expert_depth=1, expert_model=teacher)


# --- the learner's imitation objectives and the anchor ---------------------


def soft_targets(d, seed=4):
    rng = np.random.default_rng(seed)
    z = rng.normal(0, 2, (S_REAL, 4))
    q = np.where(d["mask"], 0.0, np.exp(z - z.max(1, keepdims=True)))
    q[3::11] = np.where(d["mask"][3::11], 0.0, 1.0)  # some uniform rows (gap 0)
    return (q / q.sum(1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("objective,anchored", [("imitation", False), ("imitation_sharp", False),
                                                ("imitation", True), ("imitation_sharp", True)])
def test_imitation_optimize_matches_jax(data, objective, anchored):  # noqa: F811
    """Two epochs of the lazily augmented dataset of tests/test_torch_update.py
    with soft targets (permuted with the board on augmented rows), KL
    diagnostic on; the anchor a frozen copy of other weights."""
    d = data
    q = soft_targets(d)
    cfg = JMLPConfig(hidden_dim=32, num_layers=2, dropout=0.0)
    params = jmlp.init(jax.random.key(2), cfg, zero_heads=False)
    anchor_params = jmlp.init(jax.random.key(12), cfg, zero_heads=False)
    labels = jmlp.param_labels(params)
    ocfg = dict(learning_rate=1e-3, critic_lr=3e-4)
    janchor = ((lambda p, x: jmlp.apply(p, cfg, x), anchor_params, 0.5) if anchored else None)
    joptimize = JU.make_optimize_fn(
        lambda p, x, rng: jmlp.apply(p, cfg, x, train=True, rng=rng), labels,
        jopt.OptimizerConfig(**ocfg), BATCH, EPOCHS, kl_diagnostic=True, objective=objective,
        anchor=janchor)
    jds = JU.Dataset(board_before=jnp.asarray(d["board"]), action=jnp.asarray(d["action"]),
                     action_mask=jnp.asarray(d["mask"]), advantage=jnp.asarray(d["advantage"]),
                     G_norm=jnp.asarray(d["G_norm"]), logprobs=jnp.asarray(d["logprobs"]),
                     target_probs=jnp.asarray(q), valid=jnp.asarray(d["valid"]),
                     aug_src=jnp.asarray(d["aug_src"]), aug_tf=jnp.asarray(d["aug_tf"]))
    key = jax.random.key(5)
    jparams, _, jstats = jax.jit(joptimize)(params, jopt.init(params), jds, key,
                                            jnp.float32(0.02), 0.2, jnp.float32(1.0))

    model = port_model(params, cfg)
    anchor = (port_model(anchor_params, cfg).requires_grad_(False), 0.5) if anchored else None
    frozen = {} if anchor is None else {n: p.clone() for n, p in anchor[0].state_dict().items()}
    toptimize = TU.make_optimize_fn(model, param_labels(model), topt.OptimizerConfig(**ocfg),
                                    BATCH, EPOCHS, kl_diagnostic=True, objective=objective,
                                    anchor=anchor)
    t = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    tds = TU.Dataset(board_before=t(d["board"]), action=t(d["action"]), action_mask=t(d["mask"]),
                     advantage=t(d["advantage"]), G_norm=t(d["G_norm"]),
                     logprobs=t(d["logprobs"]), target_probs=t(q), valid=t(d["valid"]),
                     aug_src=t(d["aug_src"]), aug_tf=t(d["aug_tf"]))
    tstats = toptimize(topt.init(dict(model.named_parameters())), tds, 0.02, 0.2,
                       np.float32(1.0), perm_draws=t(jax_perm_draws(key)))
    for f in TU.OptimizeStats._fields:
        tol = KL_TOL if f.startswith("kl_") else STAT_TOL
        np.testing.assert_allclose(float(getattr(tstats, f)), float(getattr(jstats, f)),
                                   rtol=tol, atol=0, err_msg=f)
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    for name, want in _flat(jparams).items():
        np.testing.assert_allclose(got[name], want, rtol=0, atol=PARAM_TOL, err_msg=name)
        assert not np.array_equal(want, np.asarray(_flat(params)[name])), name
    if anchored:
        assert all(torch.equal(p, frozen[n]) for n, p in anchor[0].state_dict().items())


def test_augmented_rows_permute_target_probs(data):  # noqa: F811
    """A virtual row's target_probs is its source row's, permuted as its
    action mask is: the legal moves keep their probability mass."""
    d = data
    q = soft_targets(d)
    t = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    ds = TU.Dataset(board_before=t(d["board"]), action=t(d["action"]), action_mask=t(d["mask"]),
                    advantage=t(d["advantage"]), G_norm=t(d["G_norm"]),
                    logprobs=t(d["logprobs"]), target_probs=t(q), valid=t(d["valid"]),
                    aug_src=t(d["aug_src"]), aug_tf=t(d["aug_tf"]))
    rows = torch.arange(S_REAL, S_REAL + len(d["aug_src"]))
    mb = TU._minibatch(ds, rows)
    moved = d["aug_tf"] != 0
    assert moved.any()
    np.testing.assert_array_equal(mb["target_probs"].numpy()[mb["mask"].numpy()], 0.0)
    assert not np.array_equal(mb["target_probs"].numpy()[moved], q[d["aug_src"]][moved])
    np.testing.assert_allclose(np.sort(mb["target_probs"].numpy(), 1),
                               np.sort(q[d["aug_src"]], 1))
    assert TU._minibatch(ds._replace(target_probs=None), rows).keys() == mb.keys() - {
        "target_probs"}
