"""The combined optimizer: Muon for 2-D weights, AdamW for the rest, the value
head on its own learning rate (counterpart of ``tpu2048/ops/optimizer.py``).

Routing comes from a label per parameter name (``muon_other``,
``muon_value``, ``adamw_other``, ``adamw_value``; ``models.mlp.param_labels``).
The gradients are clipped by their global norm (1.0) across every parameter
before routing, as ``clip_grad_norm_`` does. Decoupled weight decay uses the
raw learning rate, Muon's step the adjusted one.

The state keeps the JAX package's layout, so a ``train_state.npz`` carries
over both ways (``state_to_arrays`` / ``state_from_arrays``): a Muon
momentum buffer for every parameter (the 1-D ones stay zero), AdamW's ``m``
and ``v`` for every parameter (the 2-D ones stay zero), and one shared
AdamW step count.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import adamw, muon


@dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 1e-3  # actor and trunk
    critic_lr: float = 1e-3  # value head
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.01
    muon_momentum: float = 0.95
    muon_nesterov: bool = True
    adjust_lr_fn: str = "match_rms_adamw"
    grad_clip: float = 1.0


@dataclass
class OptState:
    """Buffers by parameter name, and AdamW's step count (a host int that
    ticks once per update)."""

    momentum: dict
    m: dict
    v: dict
    step: int = 0


def init(params: dict) -> OptState:
    zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}  # noqa: E731
    return OptState(zeros(), zeros(), zeros(), 0)


# The JAX package's key paths of the optimizer state's leaves, before the
# parameter's own key path.
_MOMENTUM, _M, _V = ".muon.momentum", ".adamw.m", ".adamw.v"
_STEP = ".adamw.step"


def state_to_arrays(state: OptState, key_path, prefix: str = "['opt_state']") -> dict:
    """{JAX key path: numpy array}; ``key_path(name)`` gives a parameter
    name's key path (``['blocks'][0]['lin']['w']``)."""
    out = {prefix + _STEP: np.asarray(state.step, np.int32)}
    for part, bufs in ((_MOMENTUM, state.momentum), (_M, state.m), (_V, state.v)):
        for name, t in bufs.items():
            out[prefix + part + key_path(name)] = t.detach().cpu().numpy()
    return out


def state_from_arrays(arrays: dict, names, key_path, device,
                      prefix: str = "['opt_state']") -> OptState:
    """The inverse of :func:`state_to_arrays` for parameters ``names``;
    a missing leaf raises KeyError naming it."""
    def bufs(part):
        return {n: torch.as_tensor(arrays[prefix + part + key_path(n)],
                                   dtype=torch.float32).to(device).clone()
                for n in names}
    return OptState(bufs(_MOMENTUM), bufs(_M), bufs(_V),
                    int(arrays[prefix + _STEP]))


def global_norm(grads: list) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


@torch.no_grad()
def update_(params: dict, grads: dict, state: OptState, labels: dict,
            schedule_mult, config: OptimizerConfig) -> torch.Tensor:
    """One optimizer step (one minibatch), in place on ``params`` (name ->
    tensor) and ``state``. ``schedule_mult`` is the schedule's float32
    multiplier for the current train step. Returns the pre-clip global
    gradient norm (a 0-d tensor on the parameters' device)."""
    names = list(params)
    g_list = [grads[n] for n in names]
    norm = global_norm(g_list)
    scale = torch.clamp(config.grad_clip / (norm + 1e-6), max=1.0)
    clipped = dict(zip(names, torch._foreach_mul(g_list, scale)))

    f32 = np.float32
    lrs = {"other": f32(config.learning_rate) * f32(schedule_mult),
           "value": f32(config.critic_lr) * f32(schedule_mult)}
    state.step += 1

    def group(opt, kind):
        return [n for n in names if labels[n] == f"{opt}_{kind}"]

    for kind, lr in lrs.items():
        # AdamW: the 1-D parameters of this lr group.
        ad = group("adamw", kind)
        adamw.update_([params[n] for n in ad], [clipped[n] for n in ad],
                      [state.m[n] for n in ad], [state.v[n] for n in ad],
                      state.step, lr, beta1=config.beta1, beta2=config.beta2,
                      weight_decay=config.weight_decay)
        # Muon: momentum and Nesterov direction, then one Newton-Schulz per
        # group of same-shape weights.
        mu_names = group("muon", kind)
        if not mu_names:
            continue
        mom = config.muon_momentum
        gs = [clipped[n] for n in mu_names]
        bufs = [state.momentum[n] for n in mu_names]
        new_bufs = torch._foreach_add(torch._foreach_mul(bufs, mom),
                                      torch._foreach_mul(gs, 1.0 - mom))
        torch._foreach_copy_(bufs, new_bufs)
        us = (torch._foreach_add(torch._foreach_mul(gs, 1.0 - mom),
                                 torch._foreach_mul(new_bufs, mom))
              if config.muon_nesterov else new_bufs)
        decay = float(f32(1.0) - lr * f32(config.weight_decay))
        by_shape = {}
        for n, u in zip(mu_names, us):
            by_shape.setdefault(tuple(u.shape), []).append((n, u))
        for shape, items in by_shape.items():
            orthos = muon.newton_schulz(torch.stack([u for _, u in items]))
            alr = float(muon.adjust_lr(lr, shape, config.adjust_lr_fn))
            for (n, _), o in zip(items, orthos):
                p = params[n]
                p.copy_(p * decay - alr * o.to(p.dtype))
    return norm
