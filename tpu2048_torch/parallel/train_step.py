"""The launch of data-parallel training's ranks over ``torch.distributed``
(the process side of ``tpu2048/parallel/train_step.py``; the step itself,
``make_sharded_train_step`` and ``init_sharded_env_carry``, is the
trainer's own, in ``train/loop.py``, where its semantics are set out).

The JAX package runs one program over a mesh of devices; here each rank is
a process. :func:`launch` starts them: ``--mesh-data D`` on one host starts
D local ranks (rank r on ``cuda:r`` over NCCL, or on the CPU over Gloo);
with ``--num-processes P --process-id i --coordinator-address A`` each
process starts D/P of them, global rank ``i * (D/P) + local``. Each rank
joins the process group (``parallel/mesh.py``) and runs ``train`` with it,
or the ``body`` it is given (``scripts/torch_bench_scaling.py`` times the
step that way).
"""

from __future__ import annotations

import dataclasses
import tempfile

import torch

from .. import resolve_device
from ..train import loop as L
from .mesh import init_distributed, shutdown, spawn


def _summary(out: dict) -> dict:
    """What a rank hands back across processes: numbers and numpy."""
    keep = {k: v for k, v in out.items()
            if k not in ("model", "moments", "recorder")}
    keep["params"] = {n: p.detach().cpu().numpy() for n, p in out["model"].named_parameters()}
    keep["moments"] = [float(m) for m in out["moments"]]
    return keep


def train_body(cfg, group) -> dict:
    """A rank's default body: ``train`` with its group, summarised."""
    return _summary(L.train(cfg, group=group))


def _rank_main(local_rank: int, cfg, url: str, procs: int, process_id: int,
               local: int, body, share_card: bool):
    ranks = procs * local
    cuda = resolve_device(cfg.device).type == "cuda"
    device = (torch.device("cuda", 0 if share_card else local_rank) if cuda
              else torch.device("cpu"))
    if device.type == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    group = init_distributed(url, procs, process_id, rank=process_id * local + local_rank,
                             world_size=ranks, device=device,
                             backend="gloo" if share_card else None)
    try:
        return body(cfg, group)
    finally:
        shutdown()


def launch(cfg, coordinator_address: str | None = None, num_processes: int | None = None,
           process_id: int | None = None, timeout_s: float | None = None, *,
           body=train_body, share_card: bool = False):
    """Train ``cfg`` data-parallel over D ranks (``--mesh-data``, or the
    process count when that is left at 1): this process's D/P local ranks,
    each running ``body(cfg, group)`` with its group (spawned when there is
    more than one). Returns what this process's first rank's body returns
    (rank 0's on process 0). The default body trains: its summary is
    ``train``'s, the model as ``params`` (numpy) and the moments as floats.
    Another ``body`` must pickle (a module-level function, or a
    ``functools.partial`` of one: it is sent to the spawned ranks) and
    return what pickles without torch tensors. Local
    ranks that are still running after ``timeout_s`` (None: no limit; the
    collectives' own timeout still ends a hung rank) are killed and the
    call raises ``TimeoutError``.

    ``share_card`` puts every local rank of a CUDA run on the one card
    ``cuda:0``, joined over Gloo: it exercises D ranks on a machine of one
    card and measures no scaling across cards.

    Raises before anything starts: ``ValueError`` unless D divides by the
    process count and the lanes (or games) and the batch by D;
    ``RuntimeError`` for a CUDA run without a card for each local rank (or
    without any card, under ``share_card``)."""
    procs = max(num_processes or 1, 1)
    if cfg.mesh_data == 1:
        cfg = dataclasses.replace(cfg, mesh_data=procs)
    ranks = cfg.mesh_data
    if ranks % procs:
        raise ValueError(f"--mesh-data {ranks} is not divisible by --num-processes {procs}")
    L.shard_sizes(cfg, ranks)
    L.check_ported(cfg)
    local = ranks // procs
    cards = 1 if share_card else local
    if resolve_device(cfg.device).type == "cuda" and cards > torch.cuda.device_count():
        raise RuntimeError(
            f"--mesh-data {ranks} over {procs} process(es) puts {local} ranks on this "
            f"host, which has {torch.cuda.device_count()} CUDA device(s): one rank a card")
    if procs > 1 and not coordinator_address:
        raise ValueError("--num-processes > 1 needs --coordinator-address host:port")
    with tempfile.TemporaryDirectory() as tmp:
        url = coordinator_address or f"file://{tmp}/rendezvous"
        args = (cfg, url, procs, process_id or 0, local, body, share_card)
        if local == 1:
            return _rank_main(0, *args)
        return spawn(_rank_main, local, args, timeout_s=timeout_s)[0]
