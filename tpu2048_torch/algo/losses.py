"""The PPO-clip actor-critic loss, the expert-iteration objective and the KL
diagnostic (counterpart of ``tpu2048/algo/losses.py``: ``smooth_l1``,
``ppo_loss``, ``imitation_loss``, ``kl_old_new``).

The reference's numerically quirky parts stay:

 * Policy logprobs come from logits masked to -inf at invalid actions; the
   log-ratio is clamped to +-20 before the exp and the ratio clipped to
   [1-eps, 1+eps] with eps = 0.2.
 * The entropy bonus uses another distribution: the -inf-masked logits are
   clamped to [-20, 20] (so invalid actions re-enter at logit -20) before a
   full 4-way log_softmax, then -sum p*logp over the VALID entries only.
 * The value loss is smooth-L1 (Huber, delta 1) against the normalised RTG.
 * loss = -mean(ppo_clip - critic*value_loss + beta*entropy); the
   imitation objective swaps ppo_clip for the gap-weighted cross-entropy
   against the expert's targets and keeps the other two terms.

Every mean is weighted, so rows of weight 0 in a fixed-size minibatch
contribute nothing.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

PPO_EPS = 0.2
LOGIT_CLAMP = 20.0


class LossStats(NamedTuple):
    loss: torch.Tensor
    policy_loss: torch.Tensor
    entropy_loss: torch.Tensor
    value_loss: torch.Tensor
    entropy: torch.Tensor


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """0.5 x^2 where |x| < 1, else |x| - 0.5 (torch's smooth_l1, beta 1)."""
    d = (pred - target).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def _masked_log_softmax(logits: torch.Tensor, action_mask: torch.Tensor) -> tuple:
    """(logits masked to -inf, log_softmax of them); a row with no valid
    action (padding only) gets uniform logits instead."""
    masked = logits.masked_fill(action_mask, float("-inf"))
    all_invalid = action_mask.all(-1, keepdim=True)
    safe = masked.masked_fill(all_invalid, 0.0)
    return masked, torch.log_softmax(safe, dim=-1)


def ppo_loss(logits, values, targets, action_mask, advantage, rtg,
             old_logprobs, weights, *, kl_strength, critic_strength,
             denom=None, target_probs=None) -> tuple:
    """(loss, LossStats) for one minibatch: logits (B, 4), values (B, 1),
    targets (B,), action_mask (B, 4) True = invalid, advantage, rtg and
    weights (B,), old_logprobs (B, 4). ``denom`` replaces the mean's
    divisor (default: the sum of the weights, at least 1).
    ``target_probs`` is accepted for the schema :func:`imitation_loss`
    shares, and unused."""
    del target_probs
    masked, logprobs = _masked_log_softmax(logits, action_mask)
    tgt = targets.long()[:, None]
    new_lp = logprobs.gather(-1, tgt)[:, 0]
    old_lp = old_logprobs.gather(-1, tgt)[:, 0]

    log_ratio = torch.clamp(new_lp - old_lp, -LOGIT_CLAMP, LOGIT_CLAMP)
    ratio = log_ratio.exp()
    clipped = torch.clamp(ratio, 1.0 - PPO_EPS, 1.0 + PPO_EPS)
    ppo_clip = torch.minimum(advantage * ratio, advantage * clipped)

    return _objective(ppo_clip, masked, action_mask, values, rtg, weights,
                      kl_strength, critic_strength, denom)


def _objective(policy_term, masked, action_mask, values, rtg, weights, kl_strength,
               critic_strength, denom) -> tuple:
    """(loss, LossStats) of ``-mean(policy_term - critic*value_loss +
    beta*entropy)``, the entropy that of the clamped distribution (the -inf
    -> -20 re-entry)."""
    lp2 = torch.log_softmax(torch.clamp(masked, -LOGIT_CLAMP, LOGIT_CLAMP), dim=-1)
    plogp = torch.where(action_mask, 0.0, lp2 * lp2.exp())
    entropy = -plogp.sum(-1)

    value_l = smooth_l1(values[:, 0], rtg)

    d = weights.sum().clamp(min=1.0) if denom is None else denom

    def wmean(x):
        return (x * weights).sum() / d

    loss = -wmean(policy_term - critic_strength * value_l + kl_strength * entropy)
    stats = LossStats(
        loss=loss.detach(),
        policy_loss=-wmean(policy_term.detach()),
        entropy_loss=-kl_strength * wmean(entropy.detach()),
        value_loss=critic_strength * wmean(value_l.detach()),
        entropy=wmean(entropy.detach()),
    )
    return loss, stats


def imitation_loss(logits, values, targets, action_mask, advantage, rtg,
                   old_logprobs, weights, *, kl_strength, critic_strength,
                   denom=None, target_probs=None, sharp=False) -> tuple:
    """(loss, LossStats) of the expert-iteration objective:

        -mean(gap * sum_a q_ce(a) log pi(a|s) - critic*value_loss + beta*entropy)

    with the entropy and value terms of :func:`ppo_loss`. ``q`` is
    ``target_probs`` (B, 4), the expert's soft target, or the one-hot of
    ``targets`` without it; ``q_ce`` is ``q``, or with ``sharp`` the one-hot
    of its first argmax. The CE terms are taken only where ``q_ce > 0`` (an
    illegal action's logprob is -inf). ``gap``, the top-1 minus top-2 of
    ``q`` without gradient, weights each row by how decisive the expert is:
    near-ties train the policy hardly at all. ``advantage`` and
    ``old_logprobs`` are accepted for the shared minibatch schema and
    unused."""
    del advantage, old_logprobs
    masked, logprobs = _masked_log_softmax(logits, action_mask)
    q = (F.one_hot(targets.long(), 4).to(torch.float32) if target_probs is None
         else target_probs)
    q_ce = F.one_hot(q.argmax(-1), 4).to(torch.float32) if sharp else q
    ce = torch.where(q_ce > 0, q_ce * logprobs, 0.0).sum(-1)
    top2 = torch.topk(q, 2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).detach()
    return _objective(gap * ce, masked, action_mask, values, rtg, weights, kl_strength,
                      critic_strength, denom)


def kl_old_new(old_logits, new_logits, action_mask, weights, denom=None) -> tuple:
    """The diagnostic KL(old || new) over the valid actions of the
    renormalised masked distributions: (kl_sum, kl_mean, kl_max), rows of
    weight 0 left out."""
    _, lp_old = _masked_log_softmax(old_logits, action_mask)
    _, lp_new = _masked_log_softmax(new_logits, action_mask)
    terms = torch.where(action_mask, 0.0, lp_old.exp() * (lp_old - lp_new))
    kl = torch.where(weights > 0, terms.sum(-1), 0.0)
    kl_sum = kl.sum()
    d = weights.sum().clamp(min=1.0) if denom is None else denom
    return kl_sum, kl_sum / d, kl.max()
