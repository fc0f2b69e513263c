#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on an NVIDIA GPU and check it.

    python3 chip_smoke.py        (from the repository root; one CUDA card,
                                  the CUDA toolkit's nvcc)

Phases, in order, each printing one line with its own seconds; any failure
raises and the run exits non-zero:

  device   the card, its count, and nvidia-smi's name and power limit
  build    nvcc builds tpu2048_torch/ops/csrc/merge4.cu; ptxas' report
  kernel   the merge kernel against its plain PyTorch version on the card,
           bit-exact, on edge boards, on boards of exponents 16-32 (a row of
           two 31s among them), and at every N of CHECK_SIZES and on either
           side of the kernel's path thresholds, through its own choice of
           design and through each design forced
  graph    one merge4_cuda call captured in a CUDA graph on 256 static
           boards; new boards copied in and replayed: bit-exact against the
           plain version on the new boards (an empty capture fails)
  timing   device time per call of the kernel (through its wrapper) and of
           the launch floor (a one-element zero_()) at every N of
           TIMING_SIZES, and of the plain version at the served batch, with
           the host's enqueue time, beside the byte bound
           (``tpu2048_torch.utils.profiling.device_ms``)
  serve    PolicyService on checkpoints_expG (H=384x3), predict in process
           on 1 and 256 boards, greedy and sampled
  eval     greedy run_eval of checkpoints_expG, 256 games
  kernels  one JSON line per the port's kernels: check, launches, times
           (at the served batch, and per timed N with the launch floor and
           the host enqueue)

The kernel launch counts are set to 0 just before the serve phase and read
after the eval phase: they count the main path only. The last line is
{"ok": true, "device": {...}}. Imports torch, numpy, the standard library and
the port; never JAX and never the tpu2048 package.
"""

from __future__ import annotations

import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from tpu2048_torch.env import engine
from tpu2048_torch.ops import merge
from tpu2048_torch.serve import PolicyService
from tpu2048_torch.train.evaluate import load_model_checkpoint, run_eval
from tpu2048_torch.utils.profiling import device_ms

ROOT = Path(__file__).resolve().parent
CHECKPOINT = ROOT / "checkpoints_expG"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
MERGE_BYTES_PER_BOARD = 64 + 4 * (64 + 4 + 4 + 1)  # read once, write once
CHECK_SIZES = (1, 7, 16, 255, 256, 257, 4096, 65537, 1048583)
TIMING_SIZES = (1, 256, 4096, 32768, 65536, 1048576)
GRAPH_BATCH = 256
SERVE_BATCH = 256
EVAL_GAMES = 256
EVAL_MAX_STEPS = 4096
EVAL_MIN_AVG = 15000  # the JAX package's greedy n=256 stream: 25,074


def phase(name: str, t0: float, text: str) -> None:
    print(f"[{name}] {time.perf_counter() - t0:.3f} s | {text}", flush=True)


def random_boards(rng: np.random.Generator, n: int) -> np.ndarray:
    """Exponents 0..15, about a third of the cells empty."""
    b = rng.integers(0, 16, size=(n, 4, 4))
    return np.where(rng.random((n, 4, 4)) < 0.35, 0, b).astype(np.int32)


def high_boards(rng: np.random.Generator, n: int) -> np.ndarray:
    """Exponents 16..32 (merge scores past 2^31 wrap, and are 0 from 2^32
    on), a third of the cells empty; the first board has a row of two 31s."""
    b = rng.integers(16, 33, size=(n, 4, 4))
    b = np.where(rng.random((n, 4, 4)) < 0.35, 0, b).astype(np.int32)
    b[0] = 0
    b[0, 0, :2] = 31
    return b


def edge_boards() -> np.ndarray:
    empty = np.zeros((4, 4), np.int32)
    no_move = (np.indices((4, 4)).sum(0) % 2 + 1).astype(np.int32)  # 1/2 checkerboard
    all_same = np.full((4, 4), 3, np.int32)
    one_big = np.zeros((4, 4), np.int32)
    one_big[1, 2] = 15
    return np.stack([empty, no_move, all_same, one_big])


def compare(boards: torch.Tensor, path: str = "auto", got=None) -> int:
    """Kernel (design ``path``, or the fields ``got`` it already wrote) vs
    plain on ``boards`` (CUDA); raises unless bit-identical. Returns the
    largest absolute difference over the four fields (0)."""
    if got is None:
        got = merge.merge4_cuda(boards, path=path)
    want = merge.merge4_plain(boards)
    torch.cuda.synchronize()
    err = 0
    for name, g, w in zip(engine.MoveSet._fields, got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: kernel {g.dtype}{tuple(g.shape)} vs "
                                 f"plain {w.dtype}{tuple(w.shape)}")
        diff = int((g.long() - w.long()).abs().max()) if g.numel() else 0
        if diff:
            n = boards.shape[0]
            bad = int((g != w).reshape(4, n, -1).any(-1).any(0).nonzero()[0])
            raise AssertionError(f"{name} differs (max |diff| {diff}, path {path}, "
                                 f"N={n}) first at board {bad}: {boards[bad].tolist()}")
        err = max(err, diff)
    return err


def main() -> None:
    # 1. device
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0].strip()
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32, as the JAX reference
    print(card, flush=True)
    phase("device", t0, f"{kind}, device_count={count}, nvidia-smi: {smi!r}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    built = merge.build()
    ptxas = [ln.strip() for ln in built.log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    phase("build", t0, f"{built.path.name} built in {built.seconds:.2f} s; "
          + " / ".join(ptxas))

    # 3. kernel: bit-exact against the plain version on the card
    t0 = time.perf_counter()
    rng = np.random.default_rng(2048)
    thresholds = merge.path_thresholds()
    sizes = sorted(set(CHECK_SIZES) | {t + d for t in thresholds for d in (-1, 0)})
    max_err = 0
    for path in merge.PATHS:
        max_err = max(max_err, compare(torch.as_tensor(edge_boards(), device="cuda"), path),
                      compare(torch.as_tensor(high_boards(rng, 4096), device="cuda"), path))
        for n in sizes:
            boards = torch.as_tensor(random_boards(rng, n), device="cuda")
            max_err = max(max_err, compare(boards, path))
    phase("kernel", t0, f"merge4 == plain on 4 edge boards, 4096 boards of exponents "
          f"16-32 and N={tuple(sizes)} (path thresholds N={thresholds}), each through "
          f"paths {tuple(merge.PATHS)}: bit-exact on all four fields, max_abs_err={max_err}")

    # 4. graph: a captured launch replays on new boards
    t0 = time.perf_counter()
    static = torch.as_tensor(random_boards(rng, GRAPH_BATCH), device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        merge.merge4_cuda(static)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = merge.merge4_cuda(static)
    for field in captured:  # what an empty capture would leave behind
        field.fill_(True if field.dtype == torch.bool else -1)
    static.copy_(torch.as_tensor(random_boards(rng, GRAPH_BATCH), device="cuda"))
    graph.replay()
    graph_err = compare(static, got=captured)
    phase("graph", t0, f"merge4_cuda captured on {GRAPH_BATCH} static boards, new "
          f"boards copied in, replayed: bit-exact, max_abs_err={graph_err}")
    del graph, captured

    # 5. timing: device time per call, with the host's enqueue time beside it
    t0 = time.perf_counter()
    floor_t = torch.zeros(1, device="cuda")
    timing = {}
    for n in TIMING_SIZES:
        boards = torch.as_tensor(random_boards(rng, n), device="cuda")
        ms, enqueue_ms = device_ms(lambda: merge.merge4_cuda(boards))
        floor_ms, _ = device_ms(lambda: floor_t.zero_())
        timing[n] = dict(ms=ms, enqueue_ms=enqueue_ms, floor_ms=floor_ms,
                         bound_ms=n * MERGE_BYTES_PER_BOARD / HBM_BYTES_PER_S * 1e3)
        if n == SERVE_BATCH:
            timing[n]["plain_ms"], timing[n]["plain_enqueue_ms"] = device_ms(
                lambda: merge.merge4_plain(boards))
    phase("timing", t0, f"card {card!r}; device ms per call (host enqueue ms): "
          + "; ".join(
              f"N={n}: kernel {t['ms']:.6f} ({t['enqueue_ms']:.6f}), launch floor "
              f"{t['floor_ms']:.6f}, bound {t['bound_ms']:.7f} (bytes)"
              + (f", plain {t['plain_ms']:.6f} ({t['plain_enqueue_ms']:.6f})"
                 if "plain_ms" in t else "")
              for n, t in timing.items()))

    # The main path starts here: every launch count goes to 0.
    merge.launches = 0

    # 6. serve
    t0 = time.perf_counter()
    svc = PolicyService(str(CHECKPOINT), device="cuda")
    cfg = svc.model_cfg
    if (cfg.hidden_dim, cfg.num_layers) != (384, 3):
        raise AssertionError(f"expected the H=384x3 flagship, got {cfg}")
    batch = random_boards(np.random.default_rng(7), SERVE_BATCH)
    batch = np.minimum(batch, 11)  # tiles a game of this model reaches
    plain_legal = engine.all_moves(torch.as_tensor(batch)).legal.T.numpy()
    for greedy in (True, False):
        one = svc.predict(batch[0], greedy=greedy)
        many = svc.predict(batch, greedy=greedy)
        probs = np.concatenate([[one["probs"]], many["probs"]])
        legal = np.concatenate([[one["legal"]], many["legal"]])
        actions = np.concatenate([[one["action"]], many["actions"]])
        if not np.array_equal(legal, np.concatenate([plain_legal[:1], plain_legal])):
            raise AssertionError("served legality differs from the plain all_moves")
        if np.any(probs[~legal] != 0.0):
            raise AssertionError("an illegal move got probability > 0")
        live = legal.any(1)
        if not np.allclose(probs[live].sum(1), 1.0, atol=1e-5):
            raise AssertionError("probabilities over the legal moves do not sum to 1")
        if not legal[live, actions[live]].all():
            raise AssertionError("an illegal action was served")
        if not np.isfinite(many["values"]).all():
            raise AssertionError("non-finite value")
    serve_launches = merge.launches
    if serve_launches < 4:
        raise AssertionError(f"serve made {serve_launches} merge launches, expected 4")
    phase("serve", t0, f"PolicyService {cfg} on 1 and {SERVE_BATCH} boards, "
          f"greedy and sampled: probs, legality and actions checked; "
          f"merge launches {serve_launches}")

    # 7. eval
    t0 = time.perf_counter()
    model, _, _ = load_model_checkpoint(str(CHECKPOINT), device="cuda")
    m = run_eval(model, EVAL_GAMES, seed=0, max_steps=EVAL_MAX_STEPS,
                 greedy=True, env_seed=12345)
    torch.cuda.synchronize()
    eval_launches = merge.launches - serve_launches
    if m["avg_score"] <= EVAL_MIN_AVG:
        raise AssertionError(f"greedy avg {m['avg_score']} <= {EVAL_MIN_AVG}")
    if eval_launches < m["steps"]:
        raise AssertionError(f"{eval_launches} merge launches for {m['steps']} steps")
    phase("eval", t0, f"greedy n={EVAL_GAMES}, max_steps={EVAL_MAX_STEPS}: "
          f"avg {m['avg_score']}, max {m['max_score']}, median "
          f"{m['median_score']}, pct_512 {m['pct_512']}, pct_1024 "
          f"{m['pct_1024']}, pct_2048 {m['pct_2048']}, steps {m['steps']}, "
          f"merge launches {eval_launches}")

    # 8. kernels
    t0 = time.perf_counter()
    main_launches = merge.launches
    t = timing[SERVE_BATCH]
    kernels = [{
        "name": "merge4", "route": "cuda",
        "source": "tpu2048_torch/ops/csrc/merge4.cu",
        "replaces": "tpu2048/ops/pallas_merge.py:129",
        "launches": main_launches, "max_abs_err": max(max_err, graph_err),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "enqueue_ms": t["enqueue_ms"], "floor_ms": t["floor_ms"],
        "by_n": {str(n): {"ms": v["ms"], "enqueue_ms": v["enqueue_ms"],
                          "floor_ms": v["floor_ms"], "bound_ms": v["bound_ms"]}
                 for n, v in timing.items()},
    }]
    phase("kernels", t0, f"merge4: bit-exact, {main_launches} launches on the "
          f"main path (serve {serve_launches}, eval {eval_launches})")
    print(json.dumps({"kernels": kernels}), flush=True)

    del svc, model
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
