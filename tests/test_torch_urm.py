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
    # A fresh module is in train mode: its dropout masks come from the
    # generator passed to forward.
    model(encode_boards(torch.as_tensor(_boards(3, 4))),
          torch.Generator().manual_seed(0))[1].sum().backward()
    assert model.init_hidden.grad is None  # only the first loop reads it
    assert model.blocks[0]["qkv"].w.grad.abs().sum() > 0


def test_greedy_loop_replays_jax_urm_rollout(models):
    _, _, model = models
    games, steps = 8, 100
    assert_greedy_loop_replays(model, jax_greedy_rollout("checkpoints_urm_r5", games, steps),
                               games, steps)


# --- Training: init, routing labels, the gradient, dropout -----------------
SMALL = dict(hidden_dim=16, num_layers=2, num_heads=2, num_loops=3, num_truncated_loops=1)
# The gradient of a small PPO loss through 3 loops of 2 blocks, float32 in
# both frameworks with sums in another order: 2e-5 relative to each leaf's
# largest gradient entry (measured: at most 1.3e-6).
GRAD_TOL = 2e-5


def _dotted(tree) -> dict:
    return {".".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in p): v
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_init_matches_jax_init():
    """Shapes, zeroed heads, unit/zero norms and the draws' bounds of a fresh
    model, against urm.init at the same config (different streams)."""
    from tpu2048_torch.models import urm as turm

    cfg = URMConfig(hidden_dim=64, num_layers=2, num_heads=4)
    want = {k: np.asarray(v) for k, v in _dotted(jurm.init(
        jax.random.key(0), JURMConfig(**cfg.to_dict()))).items()}
    model = turm.GameURM(cfg, generator=torch.Generator().manual_seed(0))
    got = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    for k in got:
        if k.startswith(("action_head", "value_head", "stem.ln.b")):
            assert not got[k].any() and not want[k].any(), k
        elif k == "stem.ln.g":
            assert (got[k] == 1).all() and (want[k] == 1).all()
        elif k == "init_hidden":
            for v in (got[k], want[k]):  # 1,024 draws of N(0, 0.02^2)
                assert abs(v.mean()) < 0.003 and 0.017 < v.std() < 0.023
        else:
            fan_in = cfg.conv_kernel if "dwconv" in k else got[k].shape[-1]
            bound = np.sqrt((1.0 if "dwconv" in k else 6.0) / fan_in)
            for v in (got[k], want[k]):  # uniform on (-bound, bound)
                assert np.abs(v).max() <= bound and np.abs(v).max() > 0.8 * bound, k
                assert abs(v.mean()) < 0.2 * bound, k
    again = turm.GameURM(cfg, generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


def test_param_labels_equal_the_reference():
    from tpu2048_torch.models import urm as turm

    jparams = jurm.init(jax.random.key(0), JURMConfig(**SMALL))
    want = _dotted(jurm.param_labels(jparams))
    got = turm.param_labels(turm.GameURM(URMConfig(**SMALL)))
    assert got == want
    assert got["init_hidden"] == "adamw_other" and got["blocks.0.dwconv.w"] == "muon_other"
    assert got["value_head.w"] == "muon_value" and got["value_head.b"] == "adamw_value"


def _ppo_batch(n=64, seed=0):
    rng = np.random.default_rng(seed)
    boards = _boards(seed, n)
    from tpu2048.env import engine as jengine

    mask = ~np.asarray(jengine.all_moves(jnp.asarray(boards)).legal).T
    mask[mask.all(1)] = False
    action = np.array([rng.choice(np.flatnonzero(~m)) for m in mask])
    logits = np.where(mask, -np.inf, rng.normal(0, 1, (n, 4)))
    old_lp = (logits - np.log(np.exp(logits).sum(1, keepdims=True))).astype(np.float32)
    return dict(boards=boards, action=action.astype(np.int32), mask=mask, old_lp=old_lp,
                adv=rng.normal(0, 1, n).astype(np.float32),
                rtg=rng.normal(0, 1, n).astype(np.float32),
                weights=(rng.random(n) < 0.9).astype(np.float32))


def test_gradient_matches_jax_grad():
    """The gradient of a PPO loss through a train-mode forward at dropout 0
    (truncated loops included) equals jax.grad of urm.apply's."""
    from tpu2048.algo import losses as jlosses
    from tpu2048_torch.algo import losses as tlosses
    from tpu2048_torch.models import urm as turm
    from tpu2048_torch.train.checkpoint import params_to_state_dict

    jcfg = JURMConfig(**SMALL, dropout=0.0)
    params = jurm.init(jax.random.key(1), jcfg, zero_heads=False)
    b = _ppo_batch()

    def jloss(p):
        logits, values = jurm.apply(p, jcfg, jencode(jnp.asarray(b["boards"])), train=True,
                                    rng=jax.random.key(2))
        return jlosses.ppo_loss(logits, values, jnp.asarray(b["action"]),
                                jnp.asarray(b["mask"]), jnp.asarray(b["adv"]),
                                jnp.asarray(b["rtg"]), jnp.asarray(b["old_lp"]),
                                jnp.asarray(b["weights"]), kl_strength=0.02,
                                critic_strength=0.2)[0]

    want_loss, want = jax.value_and_grad(jloss)(params)
    model = turm.GameURM(URMConfig(**jcfg.to_dict()))
    model.load_state_dict(params_to_state_dict(jax.tree.map(np.asarray, params)))
    model.train()
    logits, values = model(encode_boards(torch.as_tensor(b["boards"])))
    t = lambda x: torch.as_tensor(x)  # noqa: E731
    loss, _ = tlosses.ppo_loss(logits, values, t(b["action"]), t(b["mask"]), t(b["adv"]),
                               t(b["rtg"]), t(b["old_lp"]), t(b["weights"]),
                               kl_strength=0.02, critic_strength=0.2)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    want = {k: np.asarray(v) for k, v in _dotted(want).items()}
    assert not want["init_hidden"].any()  # only the truncated first loop reads it
    for name, g in zip(names, grads):
        if g is None:
            assert name == "init_hidden"
            continue
        scale = max(np.abs(want[name]).max(), 1e-12)
        np.testing.assert_allclose(g.numpy(), want[name], rtol=0, atol=GRAD_TOL * scale,
                                   err_msg=name)
        assert np.abs(want[name]).max() > 0, name


def test_dropout_masks_come_from_the_generator():
    """Train mode at dropout 0.25: masks drawn from the generator passed to
    forward (same seed, same output; another seed, another), none without
    one; eval mode unaffected. The masks keep 1 - p of the attention weights
    and scale them by 1/(1 - p), as the JAX package's dropout does (its
    masks cannot be replayed: held by the keep rate, binomial bounds)."""
    from tpu2048.models.layers import dropout as jdropout
    from tpu2048_torch.models import urm as turm
    from tpu2048_torch.models.layers import dropout as tdropout

    model = turm.GameURM(URMConfig(**SMALL, dropout=0.25), zero_heads=False,
                         generator=torch.Generator().manual_seed(0))
    x = encode_boards(torch.as_tensor(_boards(4, 8)))
    model.train()
    a = model(x, torch.Generator().manual_seed(5))[0]
    b = model(x, torch.Generator().manual_seed(5))[0]
    c = model(x, torch.Generator().manual_seed(6))[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="generator"):
        model(x)
    model.eval()
    assert torch.equal(model(x)[0], model(x, torch.Generator().manual_seed(6))[0])

    n, p = 200_000, 0.25
    got = tdropout(torch.ones(n), p, torch.Generator().manual_seed(1), True).numpy()
    want = np.asarray(jdropout(jnp.ones(n), p, jax.random.key(1), deterministic=False))
    sd = np.sqrt(n * p * (1 - p))
    for y in (got, want):
        kept = y != 0
        assert abs(kept.sum() - n * (1 - p)) < 5 * sd
        np.testing.assert_allclose(y[kept], 1 / (1 - p), rtol=1e-7)
