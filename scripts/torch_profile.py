#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's main path, on an NVIDIA GPU.

    python3 scripts/torch_profile.py [--steps 300] [--out chiprun_out/torch_profile.json]
        [--merge-baseline OLD/merge4.cu] [--merge-only] [--search-only]
        [--train-only [--train-recipe all|expG|urm|expA2|expF] [--expert-max-steps N]]

Loads checkpoints_expG (H=384x3) on ``cuda`` and, for the eval step of 256
greedy games and for a served request of 1 and of 256 boards, sets the host's
time beside the device's:

  host ms     eager calls, timed with a host clock around work that ends in
              a ``torch.cuda.synchronize()`` (median where repeated);
  device ms   the same work enqueued many times while a sleep kernel holds
              the stream, so that it then runs back to back: CUDA events
              around it time the device alone, with none of the gaps in which
              it waits for the host (``tpu2048_torch.utils.profiling``);
  enqueue ms  the host's time to enqueue one call in that loop;
  idle share  1 - device / host.

The eval step is split into its stages (encode + MLP forward, masked
argmax, the move and spawn, the merge of the next boards, the loop's own
bookkeeping).

The merge kernel is also timed alone at N = 1, 256, 4096, 32,768, 65,536 and
1,048,576: device and enqueue ms per call of ``merge4_cuda`` (its own choice
of design, and each design forced), of its plain PyTorch version, and of the
launch floor (a one-element ``zero_()``), beside the byte bound at 3.35 TB/s.
``--merge-baseline`` names the ``merge4.cu`` of an earlier commit whose
``merge4_launch`` has the first port's signature (7 arguments, no path);
it is built beside the current kernel, checked bit-exact against it, and
timed in turns (baseline, current, current, baseline) through a copy of the
first port's wrapper (four ``torch.empty``, a device guard). The script also
breaks both wrappers' host time per call down into their steps, counts the
SASS instructions of each kernel (``cuobjdump -sass``, the listing written
beside ``--out``), and checks whether a ``torch.cuda.graph`` capture of
each wrapper replays the kernel, warm and with the library's first launch
inside the capture.
``--merge-only`` skips the eval and serve measurements.

``--train-only`` splits a train step of each non-expert recipe of
``scripts/`` (``--train-recipe`` picks one), as chip_smoke.py runs it and
resumed from the committed state its script trained: expG (packed MLP
H=384x3, 512 lanes x 256, capture on; checkpoints_expG), urm (packed URM
H=64x2, 4,096 lanes x 128, capture on; checkpoints_urm_r5) and expA2
(exact episodes, MLP H=196x2, 512 games to cap 2048; checkpoints_expA).
Each step is split into rollout, advantage and learner: host ms of each in
a step run without the profiler (each part ended by a synchronize), device
ms of each in the next step, run under ``torch.profiler`` (the sum of its
kernels); the rollout per trip (one step of every lane or game) with its
merge launches; the recorder alone (the chunk's trips replayed through
``capture.record_step``), host and device ms per trip and its share of the
rollout; and the learner per minibatch: forward+backward, Newton-Schulz
and AdamW, each replayed alone at the recipe's shapes under the profiler,
and the rest (the batch gather and augmentation, the loss bookkeeping, the
clip, Muon's momentum and update) as the difference. expF (expert
iteration: scripts/train_expF_wide.sh resumed from checkpoints_expF, the
frozen depth-2 expA teacher with bf16 leaves) runs one step to the
recipe's own cap, so until its longest game ends (``--expert-max-steps``
caps it), and splits a trip into the search and the rest
(:func:`expert_step_profile`).

The search (``--search-only`` runs it alone) is measured at depth 1 over 256
games of checkpoints_expG, depth 2 over 32 games of checkpoints_expA (each
a few moves of ``play`` with ``search``, from fresh boards: a move's work is
the same for any boards, 32 spawn slots per chance node) and depth 3 on a
16-board request of checkpoints_expG (``expectimax_scores`` with
``prune_k`` 2). For each: host ms per move; the sizes each move runs the
merge and the forward at; the device time of those merges and forwards,
each replayed alone at the recorded sizes (``device_ms``); and, from
``torch.profiler`` over one move, the device time of all its kernels, of
the merge kernel (by name) and of the forwards (the forwards replayed alone
under the profiler), the rest being the difference, with the count of
device kernels and of top-level host operations the move ran. Prints one line per
measurement, flushed, and writes them all as JSON to ``--out``. Imports
torch, numpy and the port only.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import dataclasses
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from tpu2048_torch.algo import advantage as A  # noqa: E402
from tpu2048_torch.algo import losses  # noqa: E402
from tpu2048_torch.algo import rollout as R  # noqa: E402
from tpu2048_torch.algo.rollout import masked_policy, play  # noqa: E402
from tpu2048_torch.algo.search import expectimax_scores  # noqa: E402
from tpu2048_torch.env import engine  # noqa: E402
from tpu2048_torch.models.encoding import encode_boards  # noqa: E402
from tpu2048_torch.ops import _build, merge  # noqa: E402
from tpu2048_torch.serve import PolicyService  # noqa: E402
from tpu2048_torch.train.evaluate import load_model_checkpoint, load_search_coefs  # noqa: E402
from tpu2048_torch.ops import adamw, muon  # noqa: E402
from tpu2048_torch.train import cli, loop  # noqa: E402
from tpu2048_torch.utils.logger import MetricLogger  # noqa: E402
from tpu2048_torch.utils.profiling import cycles_per_ms, device_ms, host_ms  # noqa: E402

GAMES = 256
MERGE_SIZES = (1, 256, 4096, 8192, 16384, 32768, 65536, 131072, 262144, 524288, 1048576)
MERGE_BYTES_PER_BOARD = 64 + 4 * (64 + 4 + 4 + 1)  # read once, write once
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def say(text: str) -> None:
    print(text, flush=True)


def eval_step(model, steps: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(12345)
    boards = engine.reset(GAMES, "cuda", generator=gen)
    play(model, boards, 20, gen, greedy=True)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = play(model, boards, steps, gen, greedy=True)
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / res.steps

    # One trip of play()'s loop on the mid-game boards it reached, stage by
    # stage, without the trip's one wait on the device (``alive.any()``).
    boards = res.final_board.contiguous()
    moves = engine.all_moves(boards)
    draws = engine.spawn_draws((GAMES,), gen, "cuda")
    logits = model(encode_boards(boards))[0]
    action = masked_policy(logits, moves.action_mask)[0].argmax(-1)
    after = engine.step(boards, action, draws, moves=moves)
    alive = torch.ones(GAMES, dtype=torch.bool, device="cuda")
    points = torch.zeros(GAMES, dtype=torch.int32, device="cuda")

    def forward():
        return model(encode_boards(boards))

    def policy():
        return masked_policy(logits, moves.action_mask)[0].argmax(-1)

    def move_and_spawn():  # engine.step without its merge of the next boards
        a = action[None]
        moved = torch.gather(moves.boards, 0, a[..., None, None].expand(1, GAMES, 4, 4))[0]
        legal = torch.gather(moves.legal, 0, a)[0]
        zero = torch.zeros(GAMES, dtype=torch.int32, device="cuda")
        torch.where(legal, torch.gather(moves.scores, 0, a)[0], zero)
        torch.where(legal, torch.gather(moves.max_created, 0, a)[0], zero)
        board = torch.where(legal[:, None, None], engine.spawn_tile(moved, draws), boards)
        return board, ~after.moves.any_legal

    def next_merge():
        return engine.all_moves(after.board)

    def bookkeeping():  # play()'s updates after step()
        done = after.done
        pts = points + torch.where(alive, after.reward, 0)
        moves_n = points + alive.to(torch.int32)
        ended = done & alive
        final = torch.where(alive[:, None, None], after.board, boards)
        return pts, moves_n, ended, final, alive & ~done

    def whole_trip():
        lg = model(encode_boards(boards))[0]
        a = masked_policy(lg, moves.action_mask)[0].argmax(-1)
        res = engine.step(boards, a, draws, moves=moves)
        pts = points + torch.where(alive, res.reward, 0)
        moves_n = points + alive.to(torch.int32)
        ended = res.done & alive
        final = torch.where(alive[:, None, None], res.board, boards)
        return pts, moves_n, ended, final, alive & ~res.done

    stages = {}
    with torch.inference_mode():
        for name, fn in (("encode+forward", forward), ("masked argmax", policy),
                         ("move+spawn", move_and_spawn), ("merge (kernel)", next_merge),
                         ("bookkeeping", bookkeeping), ("whole trip", whole_trip)):
            dev, enq = device_ms(fn)
            stages[name] = {"device_ms": dev, "enqueue_ms": enq}
    device = stages["whole trip"]["device_ms"]
    return {"games": GAMES, "steps": res.steps, "host_ms_per_step": host,
            "device_ms_per_step": device, "device_idle_share": 1 - device / host,
            "stages": stages}


def serve_request(svc, n: int) -> dict:
    boards = np.random.default_rng(7).integers(0, 12, size=(n, 4, 4)).astype(np.int32)
    batch = boards[0] if n == 1 else boards
    host = host_ms(lambda: svc.predict(batch, greedy=True))
    b = torch.as_tensor(boards, device="cuda")

    def device_part():  # PolicyService._forward up to its copies to the host
        moves = engine.all_moves(b)
        logits, value = svc.model(encode_boards(b))
        mask = moves.action_mask
        masked = logits.masked_fill(mask, float("-inf"))
        probs = torch.softmax(torch.where(mask.all(-1, keepdim=True),
                                          torch.zeros_like(masked), masked), -1)
        return probs.masked_fill(mask, 0.0), value

    with torch.inference_mode():
        device, enqueue = device_ms(device_part)
    return {"boards": n, "host_ms_per_request": host, "device_ms_per_request": device,
            "enqueue_ms_per_request": enqueue, "device_idle_share": 1 - device / host}


class RecordingModel(torch.nn.Module):
    """``model``, keeping the row count of every forward."""

    def __init__(self, model):
        super().__init__()
        self.model, self.rows = model, []

    def forward(self, x):
        self.rows.append(x.shape[0])
        return self.model(x)


def kernel_us(prof) -> dict:
    """Device microseconds of a profile by kernel name (CUDA rows only)."""
    out = collections.Counter()
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            out[ev.key] += ev.self_device_time_total
    return out


def launch_counts(prof) -> tuple:
    """(device kernels and copies run, top-level host operations called) in
    a profile."""
    kernels = sum(ev.count for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA)
    ops = sum(1 for ev in prof.events()
              if ev.cpu_parent is None and ev.device_type == torch.autograd.DeviceType.CPU)
    return kernels, ops


def search_move(label: str, ckpt: str, n: int, depth: int, prune_k: int,
                moves: int) -> dict:
    """One configuration of the search: host ms per move (``moves`` moves of
    ``play``, or ``moves`` scorer calls when ``moves`` is negative, i.e. a
    served request), and where one move's device time goes."""
    from torch.profiler import ProfilerActivity, profile

    model, cfg, _ = load_model_checkpoint(str(ROOT / ckpt), device="cuda")
    coefs = load_search_coefs(ROOT / ckpt)
    gen = torch.Generator(device="cuda").manual_seed(12345)
    boards = engine.reset(n, "cuda", generator=gen)
    rec = RecordingModel(model)
    sizes = []
    original = merge.merge4_cuda

    def recording_merge(b, path="auto"):
        sizes.append(b.shape[0])
        return original(b, path)

    def one_move():  # what a trip of play() runs for the search
        moves_ = engine.all_moves(boards)
        action = expectimax_scores(rec, boards, moves_, coefs, depth, prune_k).argmax(-1)
        return engine.step(boards, action, engine.spawn_draws((n,), gen, "cuda"),
                           moves=moves_)

    with torch.inference_mode():
        one_move()  # warm-up
        torch.cuda.synchronize()
        reps = abs(moves)
        t0 = time.perf_counter()
        if moves > 0:
            play(model, boards, moves, gen, greedy=True, search=(coefs, depth, prune_k))
        else:
            for _ in range(reps):
                expectimax_scores(model, boards, None, coefs, depth, prune_k)
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3 / reps

        rec.rows.clear()
        merge.merge4_cuda = recording_merge
        try:
            one_move()
        finally:
            merge.merge4_cuda = original
        torch.cuda.synchronize()
        rows, merge_sizes = list(rec.rows), list(sizes)

        # Device time of the move's merges and forwards, each replayed alone.
        merge_ms = fwd_ms = 0.0
        for size, count in collections.Counter(merge_sizes).items():
            b = random_boards(size)
            merge_ms += count * device_ms(lambda: merge.merge4_cuda(b), calls=10)[0]
        for size, count in collections.Counter(rows).items():
            x = encode_boards(random_boards(size))
            fwd_ms += count * device_ms(lambda: model(x), calls=10)[0]

        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            one_move()
            torch.cuda.synchronize()
        by_kernel = kernel_us(prof)
        inputs = {size: encode_boards(random_boards(size)) for size in set(rows)}
        with profile(activities=acts) as prof_fwd:
            for size in rows:
                model(inputs[size])
            torch.cuda.synchronize()
    kernels, host_ops = launch_counts(prof)
    total_us = sum(by_kernel.values())
    merge_us = sum(v for k, v in by_kernel.items() if "merge4" in k)
    fwd_us = sum(kernel_us(prof_fwd).values())
    out = {"label": label, "checkpoint": ckpt, "config": str(cfg), "boards": n,
           "depth": depth, "prune_k": prune_k, "host_ms_per_move": host,
           "merge_calls": len(merge_sizes),
           "merge_sizes": dict(collections.Counter(merge_sizes)),
           "forward_calls": len(rows), "forward_rows": dict(collections.Counter(rows)),
           "replayed_merge_device_ms": merge_ms, "replayed_forward_device_ms": fwd_ms,
           "device_kernels_per_move": kernels, "host_ops_per_move": host_ops,
           "host_us_per_op": host * 1e3 / max(host_ops, 1)}
    if total_us:
        out.update(profiler_device_ms=total_us / 1e3, profiler_merge_ms=merge_us / 1e3,
                   profiler_forward_ms=fwd_us / 1e3,
                   profiler_rest_ms=(total_us - merge_us - fwd_us) / 1e3,
                   device_idle_share=1 - total_us / 1e3 / host,
                   top_kernels_us=dict(by_kernel.most_common(12)))
    else:
        out["profiler_device_ms"] = "not measured (the profile holds no CUDA kernels)"
    return out


SEARCH_CONFIGS = (  # label, checkpoint, boards, depth, prune_k, moves (<0: requests)
    ("depth 1, 256 games", "checkpoints_expG", 256, 1, 0, 40),
    ("depth 2, 32 games", "checkpoints_expA", 32, 2, 0, 8),
    ("depth 3, 16-board request", "checkpoints_expG", 16, 3, 2, -2),
)


def search_all(result: dict, out: Path) -> None:
    """Every SEARCH_CONFIGS entry, each written to ``out`` as it ends."""
    result["search"] = []
    for config in SEARCH_CONFIGS:
        r = search_move(*config)
        result["search"].append(r)
        say(json.dumps(r))
        out.write_text(json.dumps(result, indent=1))
    say(f"written: {out}")


def random_boards(n: int) -> torch.Tensor:
    rng = np.random.default_rng(n)
    b = rng.integers(0, 16, size=(n, 4, 4))
    return torch.as_tensor(np.where(rng.random((n, 4, 4)) < 0.35, 0, b).astype(np.int32),
                           device="cuda")


def baseline_wrapper(lib) -> callable:
    """The first port's ``merge4_cuda`` (checks, four ``torch.empty``, a
    device guard, the 7-argument ``merge4_launch``, a locked count) around
    ``lib``, a library built from that port's ``merge4.cu``."""
    lib.merge4_launch.restype = ctypes.c_int
    lib.merge4_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_void_p]
    count = [0]

    def call(boards):
        if not boards.is_cuda:
            raise ValueError("needs a CUDA tensor")
        merge._check(boards)
        if boards.data_ptr() % 16:
            raise ValueError("boards must be 16-byte aligned")
        n = boards.shape[0]
        dev = boards.device
        out = torch.empty((4, n, 4, 4), dtype=torch.int32, device=dev)
        scores = torch.empty((4, n), dtype=torch.int32, device=dev)
        max_created = torch.empty((4, n), dtype=torch.int32, device=dev)
        legal = torch.empty((4, n), dtype=torch.bool, device=dev)
        with torch.cuda.device(dev):
            rc = lib.merge4_launch(boards.data_ptr(), out.data_ptr(), scores.data_ptr(),
                                   max_created.data_ptr(), legal.data_ptr(), n,
                                   torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline merge4 launch failed (cudaError {rc})")
        with merge._count_lock:
            count[0] += 1
        return out, scores, max_created, legal

    return call


def sass_counts(path: Path, out_dir: Path) -> dict:
    """SASS instructions per kernel in the library at ``path`` (static
    count, from ``cuobjdump -sass``, whose listing goes to ``out_dir``), or
    the reason there is none."""
    tool = shutil.which("cuobjdump") or str(Path(_build.find_nvcc()).parent / "cuobjdump")
    proc = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True)
    if proc.returncode != 0:
        return {"error": proc.stderr.strip()[-300:]}
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{path.stem}.sass").write_text(proc.stdout)
    counts, name = {}, None
    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.match(r"\s*/\*[0-9a-f]{4}\*/", line):
            counts[name] += 1
    return counts


def per_call_host_us(fn, reps: int = 200, rounds: int = 7) -> float:
    """Median over rounds of the host's microseconds per ``fn()``, with a
    synchronize between rounds so that the launch queue never fills."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        times.append((time.perf_counter() - t0) * 1e6 / reps)
        torch.cuda.synchronize()
    return statistics.median(times)


def split_outputs(n: int, dev) -> tuple:
    """alloc_outputs' layout built with a split and views."""
    w = torch.empty(73 * n, dtype=torch.int32, device=dev)
    out, scores, max_created, legal = w.split_with_sizes([64 * n, 4 * n, 4 * n, n])
    return (out.view(4, n, 4, 4), scores.view(4, n), max_created.view(4, n),
            legal.view(torch.bool).view(4, n))


def guard(dev) -> None:
    with torch.cuda.device(dev):
        pass


def wrapper_breakdown(baseline, n: int = 256) -> dict:
    """Host microseconds per call of each step of the wrappers at N=n."""
    b = random_boards(n)
    dev = b.device
    idx = dev.index
    fields = merge.alloc_outputs(n, dev)
    ptrs = [t.data_ptr() for t in fields]
    lib = merge.build().lib
    stream = torch.cuda.current_stream(dev).cuda_stream
    steps = {
        "checks (is_cuda, dtype, shape, contiguity, alignment)":
            lambda: (b.is_cuda, merge._check(b), b.data_ptr() % 16),
        "four torch.empty": lambda: (
            torch.empty((4, n, 4, 4), dtype=torch.int32, device=dev),
            torch.empty((4, n), dtype=torch.int32, device=dev),
            torch.empty((4, n), dtype=torch.int32, device=dev),
            torch.empty((4, n), dtype=torch.bool, device=dev)),
        "one buffer, as_strided views (alloc_outputs)": lambda: merge.alloc_outputs(n, dev),
        "one buffer, split_with_sizes and views": lambda: split_outputs(n, dev),
        "one torch.empty alone": lambda: torch.empty(73 * n, dtype=torch.int32, device=dev),
        "torch._C._cuda_getCurrentRawStream": lambda: torch._C._cuda_getCurrentRawStream(idx),
        "ctypes merge4_launch returning at once (n=0)": lambda: lib.merge4_launch(
            b.data_ptr(), *ptrs, 0, stream, 0),
        "torch.cuda.device guard": lambda: guard(dev),
        "current_device check": lambda: idx != torch.cuda.current_device(),
        "current_stream(dev).cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "five data_ptr()": lambda: [t.data_ptr() for t in (b,) + fields],
        "ctypes merge4_launch (current kernel)": lambda: lib.merge4_launch(
            b.data_ptr(), *ptrs, n, stream, 0),
        "locked count": lambda: merge._count_lock.acquire() and merge._count_lock.release(),
        "whole merge4_cuda (current)": lambda: merge.merge4_cuda(b),
    }
    if baseline is not None:
        steps["whole merge4_cuda (first port's wrapper and kernel)"] = lambda: baseline(b)
    return {name: per_call_host_us(fn) for name, fn in steps.items()}


def capture_replays(wrapper, warm: bool = True) -> bool:
    """Capture one ``wrapper(boards)`` of 256 boards in a CUDA graph (after a
    warm-up call on a side stream, or with its first call inside the
    capture), fill its outputs with -1, copy new boards into the input and
    replay: True iff the replay wrote the merge of the new boards."""
    static = random_boards(256)
    if warm:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            wrapper(static)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = wrapper(static)
    for t in outs:
        t.fill_(True if t.dtype == torch.bool else -1)
    static.copy_(random_boards(1024)[:256])
    graph.replay()
    torch.cuda.synchronize()
    want = merge.merge4_plain(static)
    return all(torch.equal(g, w) for g, w in zip(outs, want))


def fresh_copy(path: Path, tmp: Path) -> ctypes.CDLL:
    """The library at ``path`` loaded from a copy: a new instance, with its
    own CUDA runtime state, whose kernels have never been launched."""
    dst = tmp / f"{path.stem}-copy.so"
    shutil.copy(path, dst)
    return ctypes.CDLL(str(dst))


def current_wrapper(lib) -> callable:
    """merge4_cuda's launch through ``lib``, a copy of the current library."""
    lib.merge4_launch.restype = ctypes.c_int
    lib.merge4_launch.argtypes = merge._SIGNATURES["merge4_launch"][1]

    def call(boards):
        n = boards.shape[0]
        fields = merge.alloc_outputs(n, boards.device)
        rc = lib.merge4_launch(boards.data_ptr(), *(t.data_ptr() for t in fields), n,
                               torch.cuda.current_stream().cuda_stream, 0)
        if rc != 0:
            raise RuntimeError(f"merge4 launch failed (cudaError {rc})")
        return fields

    return call


def merge_timing(baseline) -> list:
    """Per N: device and enqueue ms of the launch floor, of the current
    kernel (its choice, and each design forced), of the baseline in turns
    around it, and of the plain version, beside the byte bound."""
    floor_t = torch.zeros(1, device="cuda")
    rows = []
    for n in MERGE_SIZES:
        b = random_boards(n)
        row = {"boards": n, "bound_ms": n * MERGE_BYTES_PER_BOARD / HBM_BYTES_PER_S * 1e3}
        if baseline is not None:
            got, want = baseline(b), merge.merge4_cuda(b)
            row["baseline_equal"] = all(torch.equal(g, w) for g, w in zip(got, want))
        turns = (("baseline", "current", "current", "baseline") if baseline is not None
                 else ("current", "current"))
        for i, who in enumerate(turns):
            fn = (lambda: baseline(b)) if who == "baseline" else (lambda: merge.merge4_cuda(b))
            row[f"{who}_{i}"] = device_ms(fn)
        for path in ("small", "stream64", "stream128"):
            row[path] = device_ms(lambda: merge.merge4_cuda(b, path=path))
        row["floor"] = device_ms(lambda: floor_t.zero_())
        # Yardstick for the memory rate: copy the input four times over
        # (reads 64 B and writes 256 B per board).
        fan_out = torch.empty((4, n * 16), dtype=torch.int32, device="cuda")
        row["copy_4x"] = device_ms(lambda: fan_out.copy_(b.view(1, -1).expand(4, -1)))
        del fan_out
        row["plain"] = device_ms(lambda: merge.merge4_plain(b))
        rows.append(row)
        say(f"merge N={n}: bound {row['bound_ms']:.7f} ms; device ms (enqueue ms): "
            + "; ".join(f"{k} {v[0]:.6f} ({v[1]:.6f})" for k, v in row.items()
                        if isinstance(v, tuple))
            + (f"; baseline bit-exact {row['baseline_equal']}" if baseline is not None else ""))
    return rows


# The recipes of scripts/ as chip_smoke.py runs them, each resumed from the
# committed JAX-written state its script trained.
TRAIN_PROFILES = {
    "expG": (chip_smoke.TRAIN_RECIPE, ROOT / "checkpoints_expG"),
    "urm": (chip_smoke.URM_RECIPE, ROOT / "checkpoints_urm_r5"),
    "expA2": (chip_smoke.EXACT_RECIPE, ROOT / "checkpoints_expA"),
}
TRAIN_STEP = 100  # a step past the warmup: the schedule's multiplier is not 0
EXPERT_PROFILE_TRIPS = 4  # trips of the expert rollout under the profiler


def profiled(fn, reps: int = 1, kernel: str = "merge4") -> tuple:
    """(stats, the last call's result) of ``reps`` calls of ``fn()`` under
    ``torch.profiler``, per call: ``device_ms`` (all its kernels; None if
    the profile holds none), ``named_ms`` (the kernels whose name holds
    ``kernel``), ``kernels`` (device kernels and copies) and ``host_ops``
    (top-level host operations)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
    by_kernel = kernel_us(prof)
    total_us = sum(by_kernel.values())
    kernels, host_ops = launch_counts(prof)
    named_us = sum(v for k, v in by_kernel.items() if kernel in k)
    return {"device_ms": total_us / 1e3 / reps if total_us else None,
            "named_ms": named_us / 1e3 / reps if total_us else None,
            "kernels": kernels / reps, "host_ops": host_ops / reps}, out


def timed_host_ms(fn) -> tuple:
    """(host ms of ``fn()`` ended by a synchronize, its result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def minibatch_parts(cfg, model, labels: dict, opt_state, traj) -> dict:
    """Device ms of a learner minibatch's forward+backward, Newton-Schulz and
    AdamW, each replayed alone under the profiler at the recipe's shapes
    (the first ``batch_size`` rows of ``traj``)."""
    import copy

    flat = lambda x: x.reshape((-1,) + x.shape[2:])[:cfg.batch_size]  # noqa: E731
    inputs = encode_boards(flat(traj.board_before).to(torch.int32))
    params = dict(model.named_parameters())
    weights = torch.ones(inputs.shape[0], device="cuda")
    drop = torch.Generator(device="cuda").manual_seed(0)

    def fwd_bwd():
        model.train()
        logits, values = model(inputs, drop)
        loss, _ = losses.ppo_loss(logits, values, flat(traj.action).long(),
                                  flat(traj.action_mask), flat(traj.value_pred),
                                  flat(traj.value_pred), flat(traj.logprobs), weights,
                                  kl_strength=0.02, critic_strength=0.2)
        return torch.autograd.grad(loss, list(params.values()), allow_unused=True)

    groups = collections.defaultdict(list)
    for n, p in params.items():
        if labels[n].startswith("muon"):
            groups[tuple(p.shape)].append(p.detach())
    stacks = [torch.stack(g) for g in groups.values()]
    one_d = [n for n in params if labels[n].startswith("adamw")]
    st = copy.deepcopy(opt_state)
    p1 = [params[n].detach().clone() for n in one_d]
    g1 = [torch.randn_like(p) * 1e-3 for p in p1]
    m1, v1 = [st.m[n] for n in one_d], [st.v[n] for n in one_d]
    parts = {
        "forward+backward": profiled(fwd_bwd, reps=5)[0]["device_ms"],
        "newton_schulz": profiled(
            lambda: [muon.newton_schulz(x) for x in stacks], reps=5)[0]["device_ms"],
        "adamw": profiled(
            lambda: adamw.update_(p1, g1, m1, v1, 5, np.float32(1e-3)), reps=5)[0]["device_ms"],
    }
    model.eval()
    return parts


def train_step_profile(name: str) -> dict:
    """One train step of recipe ``name``, split (see the module docstring)."""
    from tpu2048_torch.algo import capture
    from tpu2048_torch.algo import update as U
    from tpu2048_torch.ops import optimizer as opt

    recipe, ckpt = TRAIN_PROFILES[name]
    steps = json.loads((ckpt / "train_state.json").read_text())["config"]["steps"]
    argv = recipe + ["--steps", str(steps), "--device", "cuda"]
    cfg = cli.train_config(argv)
    _, model, labels = loop.build_model(cfg)
    model.to("cuda").eval()
    opt_state, moments, key, _ = loop.load_train_state(ckpt, model, "cuda")
    carry = rec = None
    if cfg.packed:
        carry, best = loop.load_env_carry(ckpt, cfg.packed_lanes, cfg.scan_cap, "cuda",
                                          MetricLogger())
        rec = capture.mark_resumed(capture.init_recorder(
            cfg.packed_lanes, cfg.scan_cap, "cuda"), carry.ep_moves)._replace(**best)
    ocfg = opt.OptimizerConfig(learning_rate=cfg.learning_rate, critic_lr=cfg.critic_lr)
    process = loop.make_process_fn(cfg, U.make_optimize_fn(
        model, labels, ocfg, cfg.batch_size, cfg.ppo_epochs, kl_diagnostic=False))

    def gens(step):
        return {s: loop.make_generator("cuda", *key, step, s)
                for s in (loop.AUGMENT, loop.PERMUTE, loop.DROPOUT)}

    def rollout(step, carry, rec):
        """(traj, carry, recorder) of the recipe's rollout at ``step``."""
        act = loop.make_generator("cuda", *key, step, loop.ACTION)
        if not cfg.packed:
            env = loop.make_generator("cuda", *key, step, loop.EXACT_ENV)
            return (R.rollout(model, cfg.num_episodes, cfg.rollout_cap, action_generator=act,
                              env_generator=env), None, None)
        env = loop.make_generator("cuda", *carry.env_key, step)
        return R.rollout_packed(model, carry, cfg.horizon, action_generator=act,
                                env_generator=env, recorder=rec)

    # Warm-up: one whole step (cuBLAS handles, the kernel build).
    traj, carry, rec = rollout(TRAIN_STEP - 1, carry, rec)
    moments, out = process(opt_state, traj, moments, TRAIN_STEP, cfg.entropy_strength,
                           generators=gens(TRAIN_STEP - 1))
    out["scalars"].cpu()

    def advantage(traj, step):
        fields = (traj.points, traj.mono_before, traj.mono_after, traj.empt_before,
                  traj.empt_after, traj.value_pred, traj.valid)
        if cfg.packed:
            return A.compute_packed(*fields, traj.done_here, traj.boot_value,
                                    cfg.reward_weights, cfg.gamma, moments, cfg.rtg_beta, step)
        return A.compute(*fields, cfg.reward_weights, cfg.gamma, moments, cfg.rtg_beta, step)

    # Host times: a step without the profiler.
    merge_before, carry_in = merge.launches, carry
    roll_host, (traj, carry, rec) = timed_host_ms(lambda: rollout(TRAIN_STEP, carry, rec))
    merges = merge.launches - merge_before
    trips = traj.steps_executed
    adv_host, _ = timed_host_ms(lambda: advantage(traj, TRAIN_STEP + 1))
    proc_host, (moments, out) = timed_host_ms(lambda: process(
        opt_state, traj, moments, TRAIN_STEP + 1, cfg.entropy_strength,
        generators=gens(TRAIN_STEP)))
    sc = dict(zip(loop.SCALAR_KEYS, out["scalars"].tolist()))
    nb = int(sc["num_batches"])

    # The recorder alone: the chunk's trips replayed through record_step
    # from a fresh recorder, host-timed, then under the profiler.
    recorder = None
    if rec is not None:
        def record_chunk():
            r = capture.init_recorder(cfg.packed_lanes, cfg.scan_cap, "cuda")
            ep_points, ep_moves = carry_in.ep_points, carry_in.ep_moves
            for t in range(trips):
                points, done = traj.points[t], traj.done_here[t]
                r = capture.record_step(
                    r, ep_moves=ep_moves, board_before=traj.board_before[t],
                    board_after=traj.board_after[t], action=traj.action[t], points=points,
                    entropy=traj.entropy[t], done=done, ep_points_new=ep_points + points,
                    ep_moves_new=ep_moves + 1)
                ep_points = torch.where(done, 0, ep_points + points)
                ep_moves = torch.where(done, 0, ep_moves + 1)
            return r

        rec_host, _ = timed_host_ms(record_chunk)
        rec_p, _ = profiled(record_chunk)
        recorder = {"host_ms_per_trip": rec_host / trips,
                    "device_ms_per_trip": None if rec_p["device_ms"] is None
                    else rec_p["device_ms"] / trips,
                    "host_ops_per_trip": rec_p["host_ops"] / trips,
                    "kernels_per_trip": rec_p["kernels"] / trips,
                    "share_of_rollout_host": rec_host / roll_host}

    # Device times: the next step under the profiler.
    roll_p, (traj, carry, rec) = profiled(lambda: rollout(TRAIN_STEP + 1, carry, rec))
    trips_dev = traj.steps_executed
    adv_p, _ = profiled(lambda: advantage(traj, TRAIN_STEP + 2))
    proc_p, (_, out2) = profiled(lambda: process(
        opt_state, traj, moments, TRAIN_STEP + 2, cfg.entropy_strength,
        generators=gens(TRAIN_STEP + 1)))
    roll_dev, adv_dev, proc_dev = (p["device_ms"] for p in (roll_p, adv_p, proc_p))
    nb_dev = int(dict(zip(loop.SCALAR_KEYS, out2["scalars"].tolist()))["num_batches"])
    if recorder is not None and recorder["device_ms_per_trip"] is not None \
            and roll_dev is not None:
        recorder["share_of_rollout_device"] = recorder["device_ms_per_trip"] * trips_dev / roll_dev

    parts = minibatch_parts(cfg, model, labels, opt_state, traj)
    learner_dev = None if proc_dev is None or adv_dev is None else proc_dev - adv_dev
    per_mb = None if learner_dev is None else learner_dev / nb_dev
    if per_mb is not None and None not in parts.values():
        parts["rest"] = per_mb - sum(parts.values())
    return {
        "recipe": name, "config": argv, "state": f"{ckpt.name} train_state"
        + ("/env_carry" if cfg.packed else ""),
        "train_steps": [TRAIN_STEP + 1, TRAIN_STEP + 2], "env_steps": sc["env_steps"],
        "trips": [trips, trips_dev], "minibatches": [nb, nb_dev],
        "merge_launches_rollout": merges,
        "rollout": {"host_ms": roll_host, "device_ms": roll_dev,
                    "host_ms_per_trip": roll_host / trips,
                    "device_ms_per_trip": None if roll_dev is None else roll_dev / trips_dev,
                    "idle_share": None if roll_dev is None else 1 - roll_dev / roll_host,
                    "merge_device_ms": roll_p["named_ms"],
                    "kernels_per_trip": roll_p["kernels"] / trips_dev,
                    "host_ops_per_trip": roll_p["host_ops"] / trips_dev},
        "recorder": recorder,
        "advantage": {"host_ms": adv_host, "device_ms": adv_dev},
        "learner": {"host_ms": proc_host - adv_host, "device_ms": learner_dev,
                    "host_ms_per_minibatch": (proc_host - adv_host) / nb,
                    "device_ms_per_minibatch": per_mb,
                    "device_ms_per_minibatch_parts": parts,
                    "kernels_per_minibatch": (proc_p["kernels"] - adv_p["kernels"]) / nb_dev,
                    "host_ops_per_minibatch": (proc_p["host_ops"] - adv_p["host_ops"]) / nb_dev,
                    "idle_share": None if learner_dev is None
                    else 1 - learner_dev / (proc_host - adv_host)},
        "step_host_ms": roll_host + proc_host,
        "env_steps_per_s": sc["env_steps"] / (roll_host + proc_host) * 1e3,
    }


def expert_step_profile(max_steps: int) -> dict:
    """One step of scripts/train_expF_wide.sh resumed from checkpoints_expF
    (step 200), its rollout to the recipe's cap (``max_steps`` if not 0),
    split: host ms of the rollout and the learner in the step (each ended
    by a synchronize); device ms, kernels and host operations of a trip
    from EXPERT_PROFILE_TRIPS trips run under ``torch.profiler`` (a trip's
    work is set by its 32 boards, not by their tiles), with the merge
    kernel's share and the search's (the teacher's ``expectimax_scores`` of
    a trip's boards, under the profiler alone); the learner as
    :func:`train_step_profile` reports it."""
    from tpu2048_torch.algo import update as U
    from tpu2048_torch.ops import optimizer as opt

    argv = chip_smoke.EXPERT_RECIPE + ["--steps", "600", "--device", "cuda"] + (
        ["--max-steps", str(max_steps)] if max_steps else [])
    cfg = cli.train_config(argv)
    _, model, labels = loop.build_model(cfg)
    model.to("cuda").eval()
    opt_state, moments, key, manifest = loop.load_train_state(chip_smoke.EXPERT_SOURCE,
                                                              model, "cuda")
    step = manifest["train_step"] + 1
    teacher, coefs = loop.load_teacher(cfg, "cuda")
    ocfg = opt.OptimizerConfig(learning_rate=cfg.learning_rate, critic_lr=cfg.critic_lr)
    optimize = U.make_optimize_fn(model, labels, ocfg, cfg.batch_size, cfg.ppo_epochs,
                                  kl_diagnostic=False, objective=loop.objective(cfg))
    process = loop.make_process_fn(cfg, optimize)

    def rollout(trips):
        return R.rollout(
            model, cfg.num_episodes, trips,
            action_generator=loop.make_generator("cuda", *key, step, loop.ACTION),
            env_generator=loop.make_generator("cuda", *key, step, loop.EXACT_ENV),
            **loop.expert_args(cfg, teacher, coefs, moments, step + 1))

    def advantage(traj):
        return A.compute(traj.points, traj.mono_before, traj.mono_after, traj.empt_before,
                         traj.empt_after, traj.value_pred, traj.valid, cfg.reward_weights,
                         cfg.gamma, moments, cfg.rtg_beta, step + 1)

    gens = {s: loop.make_generator("cuda", *key, step, s)
            for s in (loop.AUGMENT, loop.PERMUTE, loop.DROPOUT)}
    # Warm-up: the kernel build, cuBLAS handles, the learner's first
    # backward (its first call costs about 0.5 s more on the card).
    loop.make_process_fn(dataclasses.replace(cfg, max_steps=2), optimize)(
        opt_state, rollout(2), moments, step + 1, cfg.entropy_strength, generators=gens)
    merge_before = merge.launches
    roll_host, traj = timed_host_ms(lambda: rollout(cfg.rollout_cap))
    merges, trips = merge.launches - merge_before, traj.steps_executed
    adv_host, _ = timed_host_ms(lambda: advantage(traj))
    proc_host, (_, out) = timed_host_ms(lambda: process(
        opt_state, traj, moments, step + 1, cfg.entropy_strength, generators=gens))
    sc = dict(zip(loop.SCALAR_KEYS, out["scalars"].tolist()))
    nb = int(sc["num_batches"])

    # A trip's device time, and the search's part of it on a trip's boards.
    trip_p, _ = profiled(lambda: rollout(EXPERT_PROFILE_TRIPS))
    boards = traj.board_before[trips // 2].to(torch.int32)
    moves = engine.all_moves(boards)
    with torch.inference_mode():
        search_p, _ = profiled(lambda: expectimax_scores(teacher, boards, moves, coefs,
                                                         cfg.expert_depth), reps=2)
    adv_p, _ = profiled(lambda: advantage(traj))
    proc_p, (_, out2) = profiled(lambda: process(
        opt_state, traj, moments, step + 1, cfg.entropy_strength, generators=gens))
    nb_dev = int(dict(zip(loop.SCALAR_KEYS, out2["scalars"].tolist()))["num_batches"])
    parts = minibatch_parts(cfg, model, labels, opt_state, traj)
    trip_dev = None if trip_p["device_ms"] is None else trip_p["device_ms"] / EXPERT_PROFILE_TRIPS
    learner_dev = (None if proc_p["device_ms"] is None or adv_p["device_ms"] is None
                   else proc_p["device_ms"] - adv_p["device_ms"])
    per_mb = None if learner_dev is None else learner_dev / nb_dev
    if per_mb is not None and None not in parts.values():
        parts["rest"] = per_mb - sum(parts.values())
    host_trip = roll_host / trips
    return {
        "recipe": "expF", "config": argv, "state": "checkpoints_expF train_state",
        "teacher": cfg.expert_src, "train_step": step, "cap": cfg.rollout_cap,
        "env_steps": sc["env_steps"], "trips": trips, "minibatches": [nb, nb_dev],
        "merge_launches_rollout": merges, "merge_launches_per_trip": merges / trips,
        "rollout": {"host_ms": roll_host, "host_ms_per_trip": host_trip,
                    "device_ms_per_trip": trip_dev,
                    "idle_share": None if trip_dev is None else 1 - trip_dev / host_trip,
                    "merge_device_ms_per_trip": None if trip_dev is None
                    else trip_p["named_ms"] / EXPERT_PROFILE_TRIPS,
                    "search_device_ms": search_p["device_ms"],
                    "search_share_of_trip_device": None if trip_dev is None
                    else search_p["device_ms"] / trip_dev,
                    "search_merge_device_ms": search_p["named_ms"],
                    "kernels_per_trip": trip_p["kernels"] / EXPERT_PROFILE_TRIPS,
                    "host_ops_per_trip": trip_p["host_ops"] / EXPERT_PROFILE_TRIPS},
        "advantage": {"host_ms": adv_host, "device_ms": adv_p["device_ms"]},
        "learner": {"host_ms": proc_host - adv_host, "device_ms": learner_dev,
                    "host_ms_per_minibatch": (proc_host - adv_host) / nb,
                    "device_ms_per_minibatch": per_mb,
                    "device_ms_per_minibatch_parts": parts,
                    "kernels_per_minibatch": (proc_p["kernels"] - adv_p["kernels"]) / nb_dev,
                    "host_ops_per_minibatch": (proc_p["host_ops"] - adv_p["host_ops"]) / nb_dev,
                    "idle_share": None if learner_dev is None
                    else 1 - learner_dev / (proc_host - adv_host)},
        "step_host_ms": roll_host + proc_host,
        "env_steps_per_s": sc["env_steps"] / (roll_host + proc_host) * 1e3,
        "batch_avg_score": sc["batch_avg_score"], "batch_max_score": sc["batch_max_score"],
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "torch_profile.json"))
    ap.add_argument("--merge-baseline", type=Path, default=None)
    ap.add_argument("--merge-only", action="store_true")
    ap.add_argument("--search-only", action="store_true")
    ap.add_argument("--train-only", action="store_true")
    ap.add_argument("--train-recipe", default="all", choices=("all", *TRAIN_PROFILES, "expF"))
    ap.add_argument("--expert-max-steps", type=int, default=0,
                    help="cap of the expF step's rollout (0: the recipe's)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    say(f"card: {card}, torch {torch.__version__}, sleep {cycles_per_ms():.0f} cycles/ms")
    result = {"card": card, "torch": torch.__version__}
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32, as the JAX reference
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    if args.search_only:
        search_all(result, out)
        return
    if args.train_only:
        result["train"] = {}
        names = ([*TRAIN_PROFILES, "expF"] if args.train_recipe == "all"
                 else [args.train_recipe])
        for name in names:
            result["train"][name] = (expert_step_profile(args.expert_max_steps)
                                     if name == "expF" else train_step_profile(name))
            say(json.dumps(result["train"][name]))
            out.write_text(json.dumps(result, indent=1))
        say(f"written: {out}")
        return
    built = merge.build()
    baseline = None
    result["sass"] = {"current": sass_counts(built.path, out.parent)}
    if args.merge_baseline is not None:
        old = _build.load("merge4_baseline", {}, src=args.merge_baseline)
        baseline = baseline_wrapper(old.lib)
        result["sass"]["baseline"] = sass_counts(old.path, out.parent)
    say(f"SASS instructions per kernel: {result['sass']}")
    say("ptxas: " + " / ".join(ln.strip() for ln in built.log.splitlines()
                               if "registers" in ln or "spill" in ln or "Compiling" in ln))

    # Does a captured launch replay? Warm, and with the library's first
    # launch inside the capture (a fresh copy of it).
    tmp = Path(tempfile.mkdtemp())
    wrappers = {"current": (merge.merge4_cuda,
                            current_wrapper(fresh_copy(built.path, tmp)))}
    if baseline is not None:
        wrappers["baseline"] = (baseline, baseline_wrapper(fresh_copy(old.path, tmp)))
    result["capture"] = {}
    for who, (warm_fn, cold_fn) in wrappers.items():
        for label, fn, warm in (("warm", warm_fn, True), ("first launch", cold_fn, False)):
            try:  # a measurement: a capture may fail outright
                result["capture"][f"{who}, {label}"] = capture_replays(fn, warm)
            except RuntimeError as e:
                result["capture"][f"{who}, {label}"] = f"capture failed: {e}"
    shutil.rmtree(tmp)
    say(f"graph capture replays bit-exact: {result['capture']}")

    result["wrapper_us"] = wrapper_breakdown(baseline)
    for name, us in result["wrapper_us"].items():
        say(f"  host us per call, {name}: {us:.3f}")

    result["merge"] = merge_timing(baseline)
    out.write_text(json.dumps(result, indent=1))
    if args.merge_only:
        say(f"written: {out}")
        return

    svc = PolicyService(str(ROOT / "checkpoints_expG"), device="cuda")
    ev = result["eval"] = eval_step(svc.model, args.steps)
    say(f"eval {ev['games']} games x {ev['steps']} steps: host "
        f"{ev['host_ms_per_step']:.4f} ms/step, device {ev['device_ms_per_step']:.4f} "
        f"ms/step, idle share {ev['device_idle_share']:.4f}")
    for name, st in ev["stages"].items():
        say(f"  {name}: device {st['device_ms']:.4f} ms, enqueue {st['enqueue_ms']:.4f} ms")

    result["serve"] = []
    for n in (1, 256):
        s = serve_request(svc, n)
        result["serve"].append(s)
        say(f"serve {n} boards: host {s['host_ms_per_request']:.4f} ms/request, "
            f"device {s['device_ms_per_request']:.4f} ms (enqueue "
            f"{s['enqueue_ms_per_request']:.4f}), idle share {s['device_idle_share']:.4f}")
    search_all(result, out)


if __name__ == "__main__":
    main()
