"""The learner: shuffled minibatch epochs of the PPO or the imitation
objective, with an optimizer step per minibatch (counterpart of
``tpu2048/algo/update.py``: ``Dataset``, ``OptimizeStats``,
``make_optimize_fn``), for the MLP and the URM alike (``model(inputs,
dropout_generator)`` in train mode).

 * The optimizer steps once per MINIBATCH; the learning-rate schedule ticks
   once per train step (the multiplier is an input).
 * Each epoch shuffles the rows by the stable argsort of uniform draws, with
   invalid rows set to 2.0, so the valid rows come first; exactly
   ``ceil(S / batch_size)`` minibatches run. The last window's start is
   clamped to ``S_cap - batch_size`` and its rows are weighted by their true
   position, so rows the previous minibatch trained get weight 0.
 * Augmented rows are virtual: row r >= S_real is symmetry transform
   ``aug_tf[r - S_real]`` of real row ``aug_src[r - S_real]``, made for the
   minibatch that draws it (advantage and normalised return reused).
 * After each step an optional second forward gives the KL(old || new)
   diagnostic (on by default; the expG recipe turns it off).
 * An optional anchor adds ``strength * KL(anchor || policy)`` per row to
   the loss: the KL trust region against a frozen policy.

The minibatch count is read on the host once per call (one sync); the
minibatches are then a Python loop. A dataset smaller than one minibatch,
which the JAX package's fixed-size window cannot slice, trains as one
shorter minibatch.

Data-parallel ranks pass their ``group`` (the JAX package's ``axis_name``);
``batch_size`` is then per rank. The ranks' row counts are gathered once
per call: every rank runs the MAX over ranks of the minibatch counts (a
rank whose shard is used up trains zero-weight windows), and each
minibatch's loss is normalised by the global weight sum, which follows on
the host from those counts. The gradients are summed over the ranks in one
collective of the flattened gradients per minibatch, so each rank takes the
same optimizer step; the loss and KL statistics are summed (the KL maximum
maxed) over the ranks once, at the end.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from ..env import symmetry
from ..models.encoding import encode_boards
from ..ops import optimizer as opt
from ..parallel.mesh import DataGroup, all_extrema, all_sum
from . import losses


class Dataset(NamedTuple):
    """Flat training rows: the S_real real rows, and the lazy augmentation
    plan (``aug_src``/``aug_tf``) whose rows extend ``valid`` to
    S_cap = S_real + A. Without a plan, S_cap = S_real. ``target_probs``,
    the expert's soft targets, feeds the imitation objective (PPO reads
    none; without it imitation takes the one-hot of ``action``)."""

    board_before: torch.Tensor  # (S_real, 4, 4) int8
    action: torch.Tensor  # (S_real,) int
    action_mask: torch.Tensor  # (S_real, 4) bool
    advantage: torch.Tensor  # (S_real,) float32
    G_norm: torch.Tensor  # (S_real,) float32
    logprobs: torch.Tensor  # (S_real, 4) float32
    valid: torch.Tensor  # (S_cap,) bool
    target_probs: torch.Tensor | None = None  # (S_real, 4) float32
    aug_src: torch.Tensor | None = None  # (A,) int
    aug_tf: torch.Tensor | None = None  # (A,) int


class OptimizeStats(NamedTuple):
    loss: torch.Tensor
    policy_loss: torch.Tensor
    entropy_loss: torch.Tensor
    value_loss: torch.Tensor
    grad_norm: torch.Tensor
    entropy: torch.Tensor
    kl_total: torch.Tensor
    kl_average: torch.Tensor
    kl_max: torch.Tensor
    num_batches: torch.Tensor


def _minibatch(ds: Dataset, rows: torch.Tensor) -> dict:
    """The rows' fields; virtual rows made from their source rows, their
    action vectors (mask, logprobs, target_probs) permuted with the board."""
    fields = dict(board=ds.board_before, action=ds.action, mask=ds.action_mask,
                  advantage=ds.advantage, rtg=ds.G_norm, logprobs=ds.logprobs)
    if ds.target_probs is not None:
        fields["target_probs"] = ds.target_probs
    if ds.aug_src is None:
        return {k: v[rows] for k, v in fields.items()}
    s_real, a = ds.board_before.shape[0], ds.aug_src.shape[0]
    is_aug = rows >= s_real
    a_idx = torch.clamp(rows - s_real, 0, max(a - 1, 0))
    src = torch.where(is_aug, ds.aug_src[a_idx], rows)
    tf = torch.where(is_aug, ds.aug_tf[a_idx], symmetry.IDENTITY)
    raw = {k: v[src] for k, v in fields.items()}
    out = dict(raw, board=symmetry.transform_board(raw["board"], tf),
               action=symmetry.transform_action(raw["action"], tf))
    for k in ("mask", "logprobs", "target_probs"):
        if k in raw:
            out[k] = symmetry.transform_action_vector(raw[k], tf)
    return out


LOSSES = {"ppo": losses.ppo_loss, "imitation": losses.imitation_loss,
          "imitation_sharp": partial(losses.imitation_loss, sharp=True)}


def window_weight(s: int, s_cap: int, batch_size: int, mb: int) -> int:
    """The count of weight-1 rows in minibatch ``mb`` of a dataset of
    ``s`` valid rows (valid first) and ``s_cap`` in all: the window
    ``[start, start + batch_size)``, its start clamped to ``s_cap -
    batch_size``, keeps the rows at or past its logical start and before
    ``s``."""
    logical_start = mb * batch_size
    start = min(max(logical_start, 0), max(s_cap - batch_size, 0))
    end = start + min(batch_size, s_cap - start)
    return max(0, min(end, s) - max(start, logical_start))


def _flat_sum(group: DataGroup, grads: list) -> list:
    """``grads`` summed over the ranks in one collective."""
    flat = group.sum(torch.cat([g.reshape(-1) for g in grads]))
    out, i = [], 0
    for g in grads:
        out.append(flat[i:i + g.numel()].view_as(g))
        i += g.numel()
    return out


def make_optimize_fn(model, labels: dict, opt_config: opt.OptimizerConfig,
                     batch_size: int, epochs: int, kl_diagnostic: bool = True,
                     objective: str = "ppo", anchor: tuple | None = None,
                     group: DataGroup | None = None):
    """``optimize(opt_state, dataset, beta, critic_strength, schedule_mult, *,
    perm_generator, dropout_generator, perm_draws=None) -> OptimizeStats``,
    training ``model`` (its parameters in place, in train mode) and
    ``opt_state``.

    ``objective`` names the loss in :data:`LOSSES`: ``"ppo"``, or expert
    iteration's ``"imitation"`` / ``"imitation_sharp"``
    (``losses.imitation_loss``). ``anchor`` = ``(anchor_model, strength)``,
    a frozen policy in eval mode, adds ``strength * KL(anchor || policy)``
    (the mean of ``losses.kl_old_new``, the anchor's logits without
    gradient) to each minibatch's loss; the ``loss`` statistic includes it,
    as the reference's does.

    ``perm_draws`` (epochs, S_cap) replaces the epochs' uniform draws, so a
    test can replay another shuffle; ``dropout_generator`` draws the dropout
    masks (unused at dropout 0). ``group``: train data-parallel over its
    ranks, ``batch_size`` rows a rank (module docstring)."""
    loss_impl = LOSSES[objective]
    params = dict(model.named_parameters())
    names = list(params)
    parallel = group is not None and group.size > 1

    def optimize(opt_state, dataset: Dataset, beta, critic_strength,
                 schedule_mult, *, perm_generator=None, dropout_generator=None,
                 perm_draws=None) -> OptimizeStats:
        device = dataset.valid.device
        s_cap = dataset.valid.shape[0]
        s = int(dataset.valid.sum())  # the one host sync of the learner
        nb = max(-(-s // batch_size), 0)
        if parallel:  # every rank's row count, for the minibatch count and denominators
            counts = [int(c) for c in group.gather(torch.tensor([s])).tolist()]
            nb = max(max(-(-c // batch_size), 0) for c in counts)
        zero = torch.zeros((), device=device)
        st = dict(loss=zero, policy=zero, ent_loss=zero, value=zero, gnorm=zero,
                  ent=zero, kl_total=zero, kl_avg=zero, kl_max=zero)
        model.train()
        for epoch in range(epochs):
            rnd = (perm_draws[epoch] if perm_draws is not None
                   else torch.rand(s_cap, generator=perm_generator, device=device))
            perm = torch.argsort(torch.where(dataset.valid, rnd, 2.0), stable=True)
            for mb in range(nb):
                logical_start = mb * batch_size
                start = min(max(logical_start, 0), max(s_cap - batch_size, 0))
                rows = perm[start:start + batch_size]
                batch = _minibatch(dataset, rows)
                idx = torch.arange(start, start + rows.shape[0], device=device)
                weights = ((idx >= logical_start) & (idx < s)).to(torch.float32)
                # The global weight sum, each rank's from its row count.
                denom = (float(max(sum(window_weight(c, s_cap, batch_size, mb)
                                       for c in counts), 1)) if parallel else None)
                inputs = encode_boards(batch["board"].to(torch.int32))
                logits, values = model(inputs, dropout_generator)
                loss, lstats = loss_impl(
                    logits, values, batch["action"], batch["mask"],
                    batch["advantage"], batch["rtg"], batch["logprobs"], weights,
                    kl_strength=beta, critic_strength=critic_strength, denom=denom,
                    target_probs=batch.get("target_probs"))
                if anchor is not None:
                    anchor_model, strength = anchor
                    with torch.no_grad():
                        a_logits, _ = anchor_model(inputs)
                    loss = loss + strength * losses.kl_old_new(
                        a_logits, logits, batch["mask"], weights, denom)[1]
                # A parameter the loss does not reach (the URM's init_hidden
                # under truncated backprop) gets a zero gradient, as jax.grad
                # gives it.
                grads = torch.autograd.grad(loss, [params[n] for n in names],
                                            allow_unused=True)
                grads = [torch.zeros_like(params[n]) if g is None else g
                         for n, g in zip(names, grads)]
                if parallel:
                    grads = _flat_sum(group, grads)
                grads = dict(zip(names, grads))
                gnorm = opt.update_(params, grads, opt_state, labels, schedule_mult,
                                    opt_config)
                if kl_diagnostic:
                    with torch.no_grad():
                        new_logits, _ = model(inputs, dropout_generator)
                        kl_sum, kl_mean, kl_max = losses.kl_old_new(
                            logits.detach(), new_logits, batch["mask"], weights, denom)
                    st["kl_total"] = st["kl_total"] + kl_sum
                    st["kl_avg"] = st["kl_avg"] + kl_mean
                    st["kl_max"] = torch.maximum(st["kl_max"], kl_max)
                st["loss"] = st["loss"] + loss.detach()
                st["policy"] = st["policy"] + lstats.policy_loss
                st["ent_loss"] = st["ent_loss"] + lstats.entropy_loss
                st["value"] = st["value"] + lstats.value_loss
                st["gnorm"] = st["gnorm"] + gnorm
                st["ent"] = st["ent"] + lstats.entropy
        model.eval()
        keys = ("loss", "policy", "ent_loss", "value", "ent", "kl_total", "kl_avg")
        st.update(zip(keys, all_sum(group, *(st[k] for k in keys))))
        (st["kl_max"],), _ = all_extrema(group, (st["kl_max"],))
        total = float(max(nb * epochs, 1))
        return OptimizeStats(
            loss=st["loss"] / total, policy_loss=st["policy"] / total,
            entropy_loss=st["ent_loss"] / total, value_loss=st["value"] / total,
            grad_norm=st["gnorm"] / total, entropy=st["ent"] / total,
            kl_total=st["kl_total"] / total, kl_average=st["kl_avg"] / total,
            kl_max=st["kl_max"], num_batches=torch.full((), total, device=device))

    return optimize
