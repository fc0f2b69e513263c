"""Rank bodies of the port's data-parallel tests (tests/test_torch_parallel.py).

:func:`run` is what ``tpu2048_torch.parallel.spawn`` starts in each rank: it
joins a Gloo group on the CPU and runs the named jobs in order, each a
function of this module called with the group and numpy inputs, returning
numpy. The module imports no jax, so a rank starts in about a second."""

from __future__ import annotations

import copy

import numpy as np
import torch

from tpu2048_torch.algo import advantage as A
from tpu2048_torch.algo import augment as AUG
from tpu2048_torch.algo import rollout as R
from tpu2048_torch.ops import optimizer as opt
from tpu2048_torch.parallel import mesh
from tpu2048_torch.parallel import tensor_parallel as TP
from tpu2048_torch.train import loop as L

OPT = dict(learning_rate=1e-3, critic_lr=1e-4)


def run(local_rank: int, size: int, url: str, jobs: list) -> dict:
    """{name: job(group, **kwargs)} for each (name, job, kwargs), ``job``
    named by a function of this module."""
    torch.set_num_threads(1)
    group = mesh.init_distributed(url, rank=local_rank, world_size=size, device="cpu")
    try:
        return {name: globals()[job](group, **kwargs) for name, job, kwargs in jobs}
    finally:
        mesh.shutdown()


def setup(cfg: dict, state_dict: dict | None = None) -> tuple:
    """(TrainConfig, model holding ``state_dict`` or the trainer's initial
    weights, its routing labels)."""
    tcfg = L.TrainConfig(**cfg, device="cpu")
    key = np.array([0, tcfg.seed], np.uint32)
    _, model, labels = L.build_model(tcfg, L.make_generator("cpu", *key, L.INIT))
    if state_dict is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()})
    model.eval()
    return tcfg, model, labels


def _step(group, tcfg, model, labels, **kw):
    return L.make_sharded_train_step(group, tcfg, model, labels,
                                     opt.OptimizerConfig(**OPT), **kw)


def params_of(model) -> dict:
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def scalars_of(out) -> dict:
    return dict(zip(L.SCALAR_KEYS, out.outputs["scalars"].tolist()))


def replay(group, cfg: dict, state_dict: dict, train_step: int, beta: float, draws: list,
           plans: list, perms: list, carries: list | None = None) -> dict:
    """One step of this rank on the JAX shard's replayed draws: ``draws``,
    ``plans`` ((src, transform, valid)), ``perms`` and ``carries`` ((boards,
    ep_points, ep_moves)) hold one entry per rank."""
    tcfg, model, labels = setup(cfg, state_dict)
    r = group.rank
    carry = None
    if carries is not None:
        boards, points, moves = (torch.as_tensor(x) for x in carries[r])
        carry = R.EnvCarry(boards, np.zeros(2, np.uint32), points, moves)
    anchor = ((copy.deepcopy(model).requires_grad_(False), tcfg.anchor_kl)
              if tcfg.anchor_kl > 0 else None)
    out = _step(group, tcfg, model, labels, anchor=anchor)(
        opt.init(dict(model.named_parameters())), A.RtgMoments.initial(),
        np.zeros(2, np.uint32), train_step, beta, carry,
        rollout_draws={k: torch.as_tensor(v) for k, v in draws[r].items()},
        aug_plan=AUG.AugPlan(*(torch.as_tensor(x) for x in plans[r])),
        perm_draws=torch.as_tensor(perms[r]))
    return dict(params=params_of(model), scalars=scalars_of(out),
                moments=[float(m) for m in out.moments],
                advantage=out.outputs["advantage"].numpy(),
                steps_executed=out.traj.steps_executed)


def bench_replay(group, args: dict, overrides: dict, state_dict: dict, draws: list,
                 plans: list, perms: list, carries: list | None = None) -> dict:
    """One step of scripts/torch_bench_scaling.py's harness (its config of
    ``bench_config(group.size, **args)`` with ``overrides``, and its
    ``make_step``) on this rank's replayed JAX draws, from ``state_dict``;
    and whether ``same_on_every_rank`` holds, then after rank 1 nudges a
    parameter."""
    import dataclasses

    from scripts import torch_bench_scaling as TBS

    cfg = dataclasses.replace(TBS.bench_config(group.size, **args), **overrides)
    model, step, opt_state = TBS.make_step(group, cfg, state_dict)
    r = group.rank
    carry = None
    if carries is not None:
        boards, points, moves = (torch.as_tensor(x) for x in carries[r])
        carry = R.EnvCarry(boards, np.zeros(2, np.uint32), points, moves)
    out = step(opt_state, A.RtgMoments.initial(), TBS.INIT_KEY, TBS.TRAIN_STEP, TBS.BETA,
               carry, rollout_draws={k: torch.as_tensor(v) for k, v in draws[r].items()},
               aug_plan=AUG.AugPlan(*(torch.as_tensor(x) for x in plans[r])),
               perm_draws=torch.as_tensor(perms[r]))
    params, same = params_of(model), TBS.same_on_every_rank(group, model)
    if r == 1:
        with torch.no_grad():
            next(model.parameters()).view(-1)[0] += 1e-6
    return dict(params=params, scalars=scalars_of(out),
                moments=[float(m) for m in out.moments],
                steps_executed=out.traj.steps_executed, same=same,
                same_after_nudge=TBS.same_on_every_rank(group, model))


def critic(group, cfg: dict, critics: tuple) -> list:
    """The parameters after one step from the same start at each critic
    strength."""
    got = []
    for cs in critics:
        tcfg, model, labels = setup(dict(cfg, critic_strength=cs))
        _step(group, tcfg, model, labels)(opt.init(dict(model.named_parameters())),
                                          A.RtgMoments.initial(), np.array([0, 7], np.uint32),
                                          4, 0.02)
        got.append(params_of(model))
    return got


def expert(group, cfg: dict, expert_src: str | None = None) -> dict:
    """One expert-iteration step; with ``expert_src`` also this rank's
    rollout replayed with the frozen teacher loaded on its own and with the
    live policy teaching, on the step's generators."""
    tcfg, model, labels = setup(dict(cfg, expert_src=expert_src))
    key, ts = np.array([0, 11], np.uint32), 4
    moments = A.RtgMoments.initial()
    refs = {}
    if expert_src:
        words = L.rank_words(group)
        teacher = L.load_teacher(tcfg, "cpu")
        local = tcfg.num_episodes // group.size
        for name, (t_model, t_coefs) in (("frozen", teacher), ("live", (None, None))):
            traj = R.rollout(model, local, tcfg.rollout_cap,
                             action_generator=L.make_generator("cpu", *key, ts, L.ACTION, *words),
                             env_generator=L.make_generator("cpu", *key, ts, L.EXACT_ENV, *words),
                             **L.expert_args(tcfg, t_model, t_coefs, moments, ts + 1))
            refs[name] = traj.target_probs.numpy()
    out = _step(group, tcfg, model, labels)(opt.init(dict(model.named_parameters())),
                                            moments, key, ts, 0.02)
    return dict(refs, target_probs=out.traj.target_probs.numpy(), scalars=scalars_of(out),
                params=params_of(model), total_points=out.traj.total_points.numpy())


_TRAJ_FIELDS = ("points", "mono_before", "mono_after", "empt_before", "empt_after",
                "value_pred", "valid")


def global_stats(group, cfg: dict, steps: int) -> list:
    """``steps`` steps from the trainer's initial weights and fresh lanes:
    each step's scalars and moments and this rank's records (and carries)."""
    tcfg, model, labels = setup(cfg)
    key = np.array([0, 3], np.uint32)
    step = _step(group, tcfg, model, labels)
    state, moments = opt.init(dict(model.named_parameters())), A.RtgMoments.initial()
    carry = (L.init_sharded_env_carry(group, key, tcfg.packed_lanes, "cpu")
             if tcfg.packed else None)
    got = []
    for ts in range(4, 4 + steps):
        before = moments
        out = step(state, moments, key, ts, 0.02, carry)
        moments, carry, traj = out.moments, out.carry, out.traj
        rec = dict(scalars=scalars_of(out), moments=[float(m) for m in moments],
                   moments_in=[float(m) for m in before],
                   **{k: getattr(traj, k).numpy() for k in _TRAJ_FIELDS})
        if tcfg.packed:
            rec.update(done_here=traj.done_here.numpy(), boot_value=traj.boot_value.numpy(),
                       board_before=traj.board_before.numpy(),
                       carry_boards=carry.boards.numpy(), carry_moves=carry.ep_moves.numpy())
        else:
            rec.update(total_points=traj.total_points.numpy())
        got.append(rec)
    return got


def meshes(group) -> dict:
    """make_mesh's shapes and names over the world."""
    return {str(m): (tuple(mesh.make_mesh(model_axis=m).shape),
                     mesh.make_mesh(model_axis=m).mesh_dim_names) for m in (1, 2)}


def tensor_parallel(group, cfg: dict, state_dict: dict, inputs: np.ndarray) -> dict:
    """The tensor-parallel forward over the 'model' axis of a (D/2, 2) mesh,
    and the local shard shapes."""
    _, model, _ = setup(cfg, state_dict)
    m = mesh.make_mesh(model_axis=2)
    sharded = TP.shard_mlp(model, m)
    logits, value = TP.tp_forward(model, m)(sharded, torch.as_tensor(inputs))
    return dict(logits=logits.numpy(), value=value.numpy(),
                local={n: tuple(p.to_local().shape) for n, p in sharded.items()})


def train_writes(group, argv: list, watch: str) -> list:
    """``train`` of the CLI flags ``argv`` as this rank; the files under
    ``watch`` it opened for writing, made, renamed or removed (an audit
    hook sees every one this process makes)."""
    import sys

    from tpu2048_torch.train import cli

    seen = []

    def hook(event, args):
        if event == "open" and not any(c in str(args[1]) for c in "wax+"):
            return  # opened for reading
        if event == "os.rename":  # os.rename and os.replace: (src, dst, ...)
            paths = args[:2]
        elif event in ("open", "os.remove", "os.mkdir", "os.rmdir", "os.truncate"):
            paths = args[:1]
        else:
            return
        seen.extend((event, str(p)) for p in paths if str(p).startswith(watch))

    sys.addaudithook(hook)
    L.train(cli.train_config(argv), group=group)
    return seen
