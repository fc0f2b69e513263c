#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's main path, on an NVIDIA GPU.

    python3 scripts/torch_profile.py [--steps 300] [--out chiprun_out/torch_profile.json]

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
bookkeeping). The merge kernel is also timed alone at N = 256, 4096 and
65,536, beside its plain PyTorch version. Prints one line per measurement,
flushed, and writes them all as JSON to ``--out``. Imports torch, numpy and
the port only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tpu2048_torch.algo.rollout import masked_policy, play  # noqa: E402
from tpu2048_torch.env import engine  # noqa: E402
from tpu2048_torch.models.encoding import encode_boards  # noqa: E402
from tpu2048_torch.ops import merge  # noqa: E402
from tpu2048_torch.serve import PolicyService  # noqa: E402
from tpu2048_torch.utils.profiling import cycles_per_ms, device_ms, host_ms  # noqa: E402

GAMES = 256


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


def merge_alone(n: int) -> dict:
    rng = np.random.default_rng(n)
    b = rng.integers(0, 16, size=(n, 4, 4))
    b = torch.as_tensor(np.where(rng.random((n, 4, 4)) < 0.35, 0, b).astype(np.int32),
                        device="cuda")
    kernel, kernel_enqueue = device_ms(lambda: merge.merge4_cuda(b))
    plain, plain_enqueue = device_ms(lambda: merge.merge4_plain(b))
    return {"boards": n, "kernel_device_ms": kernel,
            "kernel_enqueue_ms": kernel_enqueue, "plain_device_ms": plain,
            "plain_enqueue_ms": plain_enqueue,
            "bound_ms": n * (64 + 4 * (64 + 4 + 4 + 1)) / 3.35e12 * 1e3}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "torch_profile.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    say(f"card: {card}, torch {torch.__version__}, sleep {cycles_per_ms():.0f} cycles/ms")
    svc = PolicyService(str(ROOT / "checkpoints_expG"), device="cuda")
    result = {"card": card, "torch": torch.__version__}

    result["merge"] = []
    for n in (256, 4096, 65536):
        m = merge_alone(n)
        result["merge"].append(m)
        say(f"merge N={n}: kernel device {m['kernel_device_ms']:.6f} ms (enqueue "
            f"{m['kernel_enqueue_ms']:.6f}), plain device {m['plain_device_ms']:.6f} ms "
            f"(enqueue {m['plain_enqueue_ms']:.6f}), bound {m['bound_ms']:.6f} ms")

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

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    say(f"written: {out}")


if __name__ == "__main__":
    main()
