#!/usr/bin/env python3
"""Data-parallel scaling of the port's train step (counterpart of
``scripts/bench_scaling.py``).

    python3 scripts/torch_bench_scaling.py [--devices 1 2 4 8]
        [--envs-per-device 64] [--max-steps 256] [--batch-per-device 128]
        [--horizon 256] [--modes exact packed] [--repeats 3]
        [--device cuda|cpu] [--share-card] [--json-out PATH]

Measures env steps/s of the data-parallel train step over D ranks
(``train/loop.py::make_sharded_train_step``, each rank a process started by
``parallel/train_step.py::launch``: NCCL between cards, Gloo on the CPU) for
each D of ``--devices``, in both rollout modes:

  * exact episodes (``--envs-per-device`` games a rank, each to its end or
    ``--max-steps`` moves);
  * packed auto-reset lanes (``--envs-per-device`` lanes a rank, ``--horizon``
    steps each).

The configuration is the JAX harness's (``bench_mesh``): MLP H=196x2,
``points_weight`` 0.1, ``monotonicity_weight`` 1.0, ``upsample_ratio``
0.25, ``critic_strength`` 0.2, ``rtg_beta`` 0.99, warm-up 10 of 100 steps,
no KL diagnostic, Muon+AdamW at learning rates 1e-3 (policy) and 1e-4
(critic), train step 20 at entropy weight 0.02. As there, every run is that
step from the initial parameters, optimizer state and moments, with a new
key each run, and the packed lanes carry on from run to run: the step trains
the model in place, so each run restores the initial parameters and makes a
fresh optimizer state first, outside its timed window (JAX's step hands
back new ones, which the harness drops).

Each rank runs ``WARMUP`` (2) steps untimed (the first step of a fresh
process pays its start-up), then checks that every rank holds the same parameters,
then times ``--repeats`` steps: a host clock from a barrier to the step's
scalars on the host, the slowest rank's time. A row reports the best run's
env steps/s, the spread of the runs ((best - worst) / best), and the weak
scaling efficiency against D = 1 (env steps/s over D times D = 1's; against
the first D of ``--devices`` per rank when that is not 1).

``--device cuda`` (the default) puts rank r on card r and raises, before
anything runs, when a D of ``--devices`` exceeds ``torch.cuda.device_count()``:
it never falls back to the CPU or to ranks that share a card. ``--share-card``
puts every rank on ``cuda:0`` over Gloo: it runs D ranks on a machine of one
card and measures no scaling (every row says so). ``--device cpu`` runs the
ranks as Gloo processes on the host's cores (a check of the harness; its
numbers are the host's, not a device's). Prints one line per row; with
``--json-out``, writes the rows as JSON. Imports torch, numpy and the port
only.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from tpu2048_torch import resolve_device  # noqa: E402
from tpu2048_torch.algo import advantage as A  # noqa: E402
from tpu2048_torch.ops import merge  # noqa: E402
from tpu2048_torch.ops import optimizer as opt  # noqa: E402
from tpu2048_torch.parallel.train_step import launch  # noqa: E402
from tpu2048_torch.train import loop as L  # noqa: E402

# bench_mesh's constants: the model's init key, the packed lanes' key, the
# (1-indexed) train step and the entropy weight of every run, the learning
# rates. A run's key is (0, 1 + its index): the first warm-up run has the
# JAX harness's key(1), the first timed run (one warm-up) its key(2).
INIT_KEY = (0, 0)
CARRY_KEY = (0, 7)
TRAIN_STEP = 19  # 0-indexed: the JAX harness's jnp.int32(20)
BETA = 0.02
OPT = dict(learning_rate=1e-3, critic_lr=1e-4)
WARMUP = 2
RANK_TIMEOUT_S = 1800
NO_SCALING = "shared card: D ranks on one card over Gloo, no scaling measured"


def bench_config(n_devices: int, envs_per_device: int, max_steps: int,
                 batch_per_device: int, packed: bool = False, horizon: int = 256,
                 device: str = "cuda") -> L.TrainConfig:
    """The TrainConfig of ``bench_mesh`` (``scripts/bench_scaling.py``) on
    ``device``."""
    return L.TrainConfig(
        steps=100, num_episodes=envs_per_device * n_devices,
        batch_size=batch_per_device * n_devices, scan_cap=max_steps,
        hidden_size=196, num_layers=2, warmup_steps=10,
        points_weight=0.1, monotonicity_weight=1.0, upsample_ratio=0.25,
        critic_strength=0.2, rtg_beta=0.99, kl_diagnostic=False,
        mesh_data=n_devices,
        packed=packed, lanes=envs_per_device * n_devices, horizon=horizon,
        device=device)


def make_step(group, cfg: L.TrainConfig, state_dict: dict | None = None) -> tuple:
    """(model on the rank's device, its sharded train step, a fresh
    optimizer state): the model has the trainer's initial weights for
    ``INIT_KEY``, or ``state_dict`` (numpy arrays by parameter name)."""
    device = resolve_device(cfg.device) if group is None else group.device
    _, model, labels = L.build_model(cfg, L.make_generator("cpu", *INIT_KEY, L.INIT))
    if state_dict is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()})
    model.to(device).eval()
    step = L.make_sharded_train_step(group, cfg, model, labels, opt.OptimizerConfig(**OPT))
    return model, step, opt.init(dict(model.named_parameters()))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def same_on_every_rank(group, model) -> bool:
    """Whether every rank of ``group`` holds exactly this rank's parameters
    (the elementwise max and min over the ranks are equal)."""
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    if group is None or group.size == 1:
        return True
    return torch.equal(group.max(flat), group.min(flat))


def bench_rank(cfg: L.TrainConfig, group, repeats: int = 3) -> dict:
    """One rank's share of a row (a ``launch`` body): ``WARMUP`` untimed
    steps, the parameter check, then ``repeats`` timed steps, each from the
    initial parameters and a fresh optimizer state. Every number it returns
    is the same on every rank: for each step (``timed`` or not), its seconds
    (the slowest rank's), env steps (global) and trips (exact mode: the
    longest game's moves, capped); and the merge launches of all ranks."""
    device = resolve_device(cfg.device) if group is None else group.device
    model, step, _ = make_step(group, cfg, None)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    moments = A.RtgMoments.initial(device)
    carry = (L.init_sharded_env_carry(group, np.array(CARRY_KEY, np.uint32),
                                      cfg.packed_lanes, device) if cfg.packed else None)
    env_idx = L.SCALAR_KEYS.index("env_steps")
    launches0 = merge.launches
    barrier = torch.zeros(1, device=device)
    runs = []
    for i in range(WARMUP + repeats):
        if i == WARMUP and not same_on_every_rank(group, model):
            raise RuntimeError(f"the ranks' parameters differ after {WARMUP} warm-up steps")
        model.load_state_dict(initial)
        opt_state = opt.init(dict(model.named_parameters()))
        if group is not None:
            group.sum(barrier)
        _sync(device)
        t0 = time.perf_counter()
        res = step(opt_state, moments, (0, 1 + i), TRAIN_STEP, BETA, carry)
        env_steps = float(res.outputs["scalars"][env_idx].cpu())  # the host waits here
        seconds = torch.tensor([time.perf_counter() - t0], dtype=torch.float64, device=device)
        if group is not None:
            seconds = group.max(seconds)
        carry = res.carry
        runs.append(dict(timed=i >= WARMUP, seconds=float(seconds), env_steps=env_steps,
                         trips=None if cfg.packed else res.traj.steps_executed))
    launches = torch.tensor([merge.launches - launches0], dtype=torch.float64, device=device)
    if group is not None:
        launches = group.sum(launches)
    return dict(runs=runs, launches=int(launches), ranks=1 if group is None else group.size,
                backend=None if group is None else group.backend)


def bench_mesh(n_devices: int, envs_per_device: int, max_steps: int, batch_per_device: int,
               repeats: int = 3, packed: bool = False, horizon: int = 256,
               device: str = "cuda", share_card: bool = False) -> dict:
    """One row: the step of ``bench_config`` over ``n_devices`` ranks
    through ``launch``; ``bench_rank``'s result with ``env_steps_per_s``
    (the best timed run's), ``spread`` ((best - worst) / best over the
    timed runs) and ``env_steps_per_s_runs``."""
    cfg = bench_config(n_devices, envs_per_device, max_steps, batch_per_device, packed,
                       horizon, device)
    out = launch(cfg, timeout_s=RANK_TIMEOUT_S, share_card=share_card,
                 body=functools.partial(bench_rank, repeats=repeats))
    rates = [r["env_steps"] / r["seconds"] for r in out["runs"] if r["timed"]]
    best = max(rates)
    return dict(out, env_steps_per_s=best, spread=(best - min(rates)) / best,
                env_steps_per_s_runs=rates)


def check_sizes(sizes, device: str, share_card: bool) -> None:
    """Raise, before anything runs, for a size this machine cannot give one
    card a rank (or for ``share_card`` off the card)."""
    if share_card and torch.device(device).type != "cuda":
        raise ValueError("--share-card puts the ranks on one CUDA card: it needs --device cuda")
    if torch.device(device).type == "cuda":
        resolve_device(device)
        have = torch.cuda.device_count()
        if not share_card and max(sizes) > have:
            raise RuntimeError(f"--devices {max(sizes)} needs {max(sizes)} CUDA cards, one a "
                               f"rank; this machine has {have} (--share-card runs the ranks "
                               "on one card, measuring no scaling)")


def run(sizes, modes=("exact", "packed"), envs_per_device: int = 64, max_steps: int = 256,
        batch_per_device: int = 128, horizon: int = 256, repeats: int = 3,
        device: str = "cuda", share_card: bool = False, say=print) -> list:
    """Every row of ``modes`` x ``sizes``, each with ``mode``, ``mesh`` and
    ``weak_scaling_efficiency`` (env steps/s a rank against the mode's
    first size's, which is D = 1's when the sizes start at 1), printed
    through ``say`` as it is measured."""
    check_sizes(sizes, device, share_card)
    rows = []
    for mode in modes:
        base = None
        for n in sizes:
            row = bench_mesh(n, envs_per_device, max_steps, batch_per_device, repeats,
                             mode == "packed", horizon, device, share_card)
            base = base or row["env_steps_per_s"] / n
            row.update(mode=mode, mesh=n, shared_card=share_card,
                       weak_scaling_efficiency=row["env_steps_per_s"] / (base * n))
            rows.append(row)
            say(f"{mode:6s} mesh={n:3d}  {row['env_steps_per_s']:12,.0f} env-steps/s  "
                f"spread {row['spread'] * 100:5.1f}%  efficiency "
                f"{row['weak_scaling_efficiency'] * 100:6.1f}%  ({row['backend'] or 'no group'}"
                f", merge launches {row['launches']})"
                + (f"  [{NO_SCALING}]" if share_card else ""))
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, nargs="+", default=None)
    ap.add_argument("--envs-per-device", type=int, default=64)
    ap.add_argument("--max-steps", type=int, default=256)
    ap.add_argument("--batch-per-device", type=int, default=128)
    ap.add_argument("--horizon", type=int, default=256,
                    help="Packed mode: env steps per lane per train step")
    ap.add_argument("--modes", nargs="+", default=["exact", "packed"],
                    choices=["exact", "packed"])
    ap.add_argument("--repeats", type=int, default=3, help="timed steps per row")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--share-card", action="store_true",
                    help="every rank on cuda:0 over Gloo (measures no scaling)")
    ap.add_argument("--json-out", default=None,
                    help="Write the weak-scaling table to this JSON file")
    args = ap.parse_args(argv)

    cuda = args.device == "cuda"
    avail = torch.cuda.device_count() if cuda else os.cpu_count()
    sizes = args.devices or [d for d in (1, 2, 4, 8, 16, 32) if d <= avail]
    kind = (torch.cuda.get_device_name(0) if avail else "no card") if cuda else "host cores"
    print(f"devices available: {avail} ({args.device}: {kind})"
          + (f"; {NO_SCALING}" if args.share_card else ""), flush=True)
    rows = run(sizes, args.modes, args.envs_per_device, args.max_steps,
               args.batch_per_device, args.horizon, args.repeats, args.device, args.share_card, say=lambda s: print(s, flush=True))
    if args.json_out:
        doc = dict(
            harness="scripts/torch_bench_scaling.py",
            workload=dict(envs_per_device=args.envs_per_device,
                          batch_per_device=args.batch_per_device,
                          max_steps=args.max_steps, horizon=args.horizon,
                          model="mlp_h196_l2", upsample_ratio=0.25,
                          repeats=args.repeats, warmup=WARMUP),
            device=args.device, device_kind=kind, devices_available=avail,
            host_cpus=os.cpu_count(), shared_card=args.share_card,
            note=NO_SCALING if args.share_card else None, rows=rows)
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(doc, indent=2))
        print(f"wrote {args.json_out}")
    return rows


if __name__ == "__main__":
    main()
