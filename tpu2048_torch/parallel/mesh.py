"""Process groups for data-parallel training (counterpart of
``tpu2048/parallel/mesh.py``: ``make_mesh`` and ``initialize_distributed``).

The JAX package runs one program over a mesh of devices; here each rank of
the ('data',) axis is a process of its own, joined by ``torch.distributed``:
NCCL between cards, Gloo on the CPU. :func:`init_distributed` makes the
process group and hands back a :class:`DataGroup`, the collectives the
trainer threads through its stages where the JAX package passes
``axis_name``: ``sum`` (psum), ``max``/``min`` (pmax/pmin), ``gather``
(``all_gather(...).reshape(-1)``). A group of one rank, or ``None``, makes
each of them the identity, so the single-device trainer runs the same code.

:func:`spawn` starts local ranks as processes (the ``spawn`` start method)
and collects what each returns. :func:`make_mesh` builds the 2-D
('data', 'model') ``DeviceMesh`` that tensor parallelism
(``parallel/tensor_parallel.py``) shards over.
"""

from __future__ import annotations

import time
from datetime import timedelta

import torch
import torch.distributed as dist

# The rendezvous: a rank that never arrives fails the run after this long.
RENDEZVOUS_TIMEOUT_S = 120
# The trainer's collectives: the ranks of an exact-mode step wait at its end
# for the rank whose games run longest (minutes under a depth-2 expert).
COLLECTIVE_TIMEOUT_S = 1800


class DataGroup:
    """The ranks of the 'data' axis: this process's ``rank`` of ``size``,
    its ``device``, and the collectives over them. ``num_processes`` is the
    launch's count of processes (hosts); the trainer keeps the single-host
    features (the lanes' checkpoint, the episode fetch) to runs of one.

    Each collective returns a new tensor on the input's device. Under Gloo a
    CUDA tensor is staged through the host. ``stats`` counts the calls, the
    bytes each rank sends and the host seconds spent in them."""

    def __init__(self, rank: int = 0, size: int = 1, *, group=None, device="cpu",
                 backend: str = "gloo", num_processes: int = 1):
        self.rank, self.size, self.group = rank, size, group
        self.device = torch.device(device)
        self.backend, self.num_processes = backend, num_processes
        self.stats = dict(calls=0, bytes=0, seconds=0.0)

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        """A contiguous copy of ``t`` on the device the backend reads."""
        if self.backend == "gloo" and t.is_cuda:
            return t.detach().to("cpu", copy=True).contiguous()
        return t.detach().clone().contiguous()

    def _count(self, t0: float, x: torch.Tensor) -> None:
        self.stats["calls"] += 1
        self.stats["bytes"] += x.numel() * x.element_size()
        self.stats["seconds"] += time.perf_counter() - t0

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if self.size == 1:
            return t
        t0 = time.perf_counter()
        x = self._staged(t)
        dist.all_reduce(x, op=op, group=self.group)
        self._count(t0, x)
        return x.to(t.device)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.SUM)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.MAX)

    def min(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.MIN)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along axis 0 in rank order (a 0-d
        tensor counts as one row)."""
        if self.size == 1:
            return t
        t0 = time.perf_counter()
        x = self._staged(t.reshape((1,) if t.dim() == 0 else t.shape))
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        self._count(t0, x)
        return torch.cat(parts).to(t.device)

    def broadcast_object(self, obj, src: int):
        """Rank ``src``'s picklable ``obj``, on every rank (a call in
        ``stats``; its pickled bytes are not counted)."""
        if self.size == 1:
            return obj
        t0 = time.perf_counter()
        box = [obj if self.rank == src else None]
        dist.broadcast_object_list(box, src=src, group=self.group,
                                   device=self.device if self.backend == "nccl" else None)
        self.stats["calls"] += 1
        self.stats["seconds"] += time.perf_counter() - t0
        return box[0]


def all_sum(group: DataGroup | None, *xs: torch.Tensor) -> tuple:
    """The 0-d tensors ``xs`` each summed over the ranks, in one collective
    (float64 on the wire, so counts stay exact); each keeps its dtype. A
    single rank gets ``xs`` back untouched."""
    if group is None or group.size == 1:
        return xs
    s = group.sum(torch.stack([x.to(torch.float64) for x in xs]))
    return tuple(s[i].to(x.dtype) for i, x in enumerate(xs))


def all_extrema(group: DataGroup | None, maxes: tuple, mins: tuple = ()) -> tuple:
    """(each of ``maxes`` maxed over the ranks, each of ``mins`` minned), in
    one collective (a min is the negated max of the negation, exactly)."""
    if group is None or group.size == 1:
        return tuple(maxes), tuple(mins)
    s = group.max(torch.stack([x.to(torch.float64) for x in maxes]
                              + [-x.to(torch.float64) for x in mins]))
    k = len(maxes)
    return (tuple(s[i].to(x.dtype) for i, x in enumerate(maxes)),
            tuple((-s[k + i]).to(x.dtype) for i, x in enumerate(mins)))


def init_distributed(coordinator_address: str, num_processes: int | None = None,
                     process_id: int | None = None, *, rank: int, world_size: int,
                     device, backend: str | None = None) -> DataGroup:
    """Join the process group as global ``rank`` of ``world_size`` and
    return its :class:`DataGroup` on ``device``.

    ``coordinator_address`` is ``host:port`` (TCP; rank 0 serves the
    store there) or an ``init_method`` URL (``tcp://...``, ``file://...``).
    ``backend`` defaults to NCCL on a CUDA device and Gloo on the CPU. The
    rendezvous fails after ``RENDEZVOUS_TIMEOUT_S``; the trainer's
    collectives run on a group of their own that waits
    ``COLLECTIVE_TIMEOUT_S``.
    ``num_processes``/``process_id`` describe the launch (hosts); the ranks
    are counted by ``rank``/``world_size``."""
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, rank=rank, world_size=world_size,
                            timeout=timedelta(seconds=RENDEZVOUS_TIMEOUT_S))
    group = dist.new_group(backend=backend, timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return DataGroup(rank, world_size, group=group, device=device, backend=backend,
                     num_processes=num_processes or 1)


def shutdown() -> None:
    """Leave the process group (if this process is in one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(num_devices: int | None = None, model_axis: int = 1):
    """A ('data', 'model') ``DeviceMesh`` of ``num_devices`` ranks (default:
    the world), ``model_axis`` of them along 'model'; raises ``ValueError``
    when ``num_devices`` does not divide by ``model_axis``, as the JAX
    package's ``make_mesh`` does. The process group must be up."""
    n = num_devices if num_devices is not None else dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"{n} devices not divisible by model axis {model_axis}")
    from torch.distributed.device_mesh import DeviceMesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(n // model_axis, model_axis),
                      mesh_dim_names=("data", "model"))


def _spawned(index: int, fn, args: tuple, results) -> None:
    results.put((index, fn(index, *args)))


def spawn(fn, nprocs: int, args: tuple = (), timeout_s: float | None = None) -> list:
    """``[fn(i, *args) for i in range(nprocs)]``, each call in a process of
    its own (the ``spawn`` start method: ``fn`` and ``args`` must pickle and
    ``fn``'s module must import without side effects). What ``fn`` returns
    must pickle without torch tensors. A rank that raises fails the call
    with its traceback and the others are terminated; so are all of them
    when ``timeout_s`` runs out (``TimeoutError``)."""
    import torch.multiprocessing as mp

    results = mp.get_context("spawn").SimpleQueue()
    ctx = mp.start_processes(_spawned, args=(fn, args, results), nprocs=nprocs,
                             join=False, start_method="spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    got = {}

    def drain():
        while not results.empty():
            i, value = results.get()
            got[i] = value

    try:
        while True:
            drain()  # a large result blocks its process until it is read
            if ctx.join(timeout=0.2):
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks still running after {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    drain()
    return [got[i] for i in range(nprocs)]
