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
  search   the same service with "search" 1, 2 and 3 on 256, 32 and 17
           boards (17 crosses the 16-board depth-3 chunk): search_scores
           finite exactly where legal and None elsewhere, a legal action;
           4 boards at depths 1 and 2 against a CPU copy of the service
           (plain merge, CPU GEMMs); the 17-board answer's first 16 rows
           against a 16-board request
  search_eval  evaluate_checkpoint(checkpoints_expA, search=True,
           search_depth=2) over 32 games (one chunk): average above a
           floor fixed before the first run
  urm      checkpoints_urm_r5 on the card: each block and the whole forward
           on 256 boards against the CPU, then a greedy run_eval of 256
           games with an average above a floor
  train    a fresh run of the expG recipe (MLP H=384x3, 512 lanes x 256
           steps, batch 4096, Muon+AdamW, adaptive entropy), 3 steps: step 1
           (warmup multiplier 0) leaves every parameter bit-identical and
           steps 2-3 change them; every scalar finite; 131,072 env steps and
           ceil(S/4096) minibatches a step; the first policy uniform over the
           legal moves; 512 merge launches a step. Then one learner
           minibatch on the step-1 chunk, on the card and on a CPU copy
           (same parameters, optimizer state, plan and shuffle): loss and
           gradient norm to LEARNER_RTOL, new parameters to LEARNER_ATOL
  train_resume  a copy of checkpoints_expG's train_state and env_carry
           (JAX-written, step 19,999) resumed for 2 steps of the same
           recipe with an eval of 32 sampled games after each: it starts at
           step 20000 on the 512 carried boards, its completed episodes and
           its eval average clear floors fixed before the first run, and
           its step-20001 train_state reads back
  kernels  one JSON line per the port's kernels: check, launches (by
           phase), times (at the served batch, and per timed N with the
           launch floor and the host enqueue)

The kernel launch counts are set to 0 just before the serve phase and read
after the train_resume phase: they count the main path only. The last line is
{"ok": true, "device": {...}}. Imports torch, numpy, the standard library and
the port; never JAX and never the tpu2048 package.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from tpu2048_torch.algo import advantage as A
from tpu2048_torch.algo import augment as AUG
from tpu2048_torch.algo import update as U
from tpu2048_torch.env import engine
from tpu2048_torch.models.encoding import encode_boards
from tpu2048_torch.models.mlp import param_labels
from tpu2048_torch.ops import merge
from tpu2048_torch.ops import optimizer as opt
from tpu2048_torch.serve import PolicyService
from tpu2048_torch.train import cli
from tpu2048_torch.train import loop
from tpu2048_torch.train.evaluate import (evaluate_checkpoint,
                                          load_model_checkpoint, run_eval)
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
SEARCH_BATCHES = {1: 256, 2: 32, 3: 17}  # boards per request at each depth
SEARCH_CPU_BOARDS = 4
SEARCH_TOL = 1e-4  # f32 sums over 32 spawn slots per level, other order
SEARCH_EVAL_CHECKPOINT = ROOT / "checkpoints_expA"
# One depth-2 chunk. The phase's time is its longest game's moves times a
# host-bound ~0.1 s a move, nearly whatever the number of games: 32 games
# (1,807 moves) took 148-189 s on the H100, 16 games (one of 2,548 moves)
# 214 s.
SEARCH_EVAL_GAMES = 32
# Fixed before the first run. The JAX package on the TPU, its own spawns:
# greedy 8,178 (n=256), depth 2 24,532 (n=128); its first, wrong scorer
# 9,989 at depth 2. The floor separates the calibrated backup from that.
SEARCH_EVAL_MIN_AVG = 15000
URM_CHECKPOINT = ROOT / "checkpoints_urm_r5"
URM_BATCH = 256
URM_GAMES = 256
# The JAX package's greedy average on the TPU, its own spawns: 12,495.
URM_MIN_AVG = 8000
# One block against the CPU: f32 GEMMs, softmax and norms summed in another
# order. The whole forward runs 8 blocks, and the recurrence roughly doubles
# a difference per block in its last loops (measured on the CPU against the
# JAX package: 2e-6 per block grows to 5e-5 in the logits), hence 1e-4.
URM_BLOCK_TOL = 1e-5
URM_FORWARD_TOL = 1e-4
# The expG recipe (scripts/train_expG_packed_ppo.sh) as the port runs it:
# no viz export, no best-episode capture (neither is ported).
TRAIN_RECIPE = [
    "--packed", "--lanes", "512", "--horizon", "256", "--batch-size", "4096",
    "--lr", "1e-3", "--critic-lr", "1e-4", "-H", "384", "--num-layers", "3",
    "--gamma", "0.995", "--dropout", "0.0", "--entropy", "0.02", "--adaptive-beta",
    "--target-entropy", "0.25", "--beta-min", "0.001", "--beta-max", "0.05",
    "--beta-lr", "0.005", "--points", "0.10", "--mono", "1.0", "--critic", "0.2",
    "--rtg-beta", "0.99", "--warmup-steps", "20", "--upsample-ratio", "0.25",
    "-t", "mlp", "--no-kl-diagnostic", "--no-packed-capture", "--print-freq", "1000"]
TRAIN_STEPS = 3
ENV_STEPS_PER_STEP = 512 * 256
MERGES_PER_STEP = 2 * 256  # all_moves of the boards, then of the next boards
# One learner minibatch, card against CPU: f32 GEMMs summed in another order
# and bf16 Newton-Schulz products rounded on other units.
LEARNER_ROWS, LEARNER_SLOTS = 3072, 512  # + 2 x 512 planned rows: one minibatch
LEARNER_RTOL = 1e-4
LEARNER_ATOL = 1e-4
RESUME_SOURCE = ROOT / "checkpoints_expG"  # step 19,999 of the JAX run
RESUME_STEPS = 20002
RESUME_EVAL_GAMES = 32
# Floors fixed before the first card run. The JAX run's EMA of the completed
# episodes' average at step 19,999 is 22,716 (TPU, train_state.json), and
# its lr is about 0 this near the end of the cosine schedule.
RESUME_MIN_EPISODE_AVG = 15000
RESUME_MIN_EVAL_AVG = 12000


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


def check_search_answer(out: dict, n: int, depth: int) -> np.ndarray:
    """The (n, 4) search scores of a served answer (NaN for None), after
    checking them against its legality and its actions."""
    legal = np.asarray(out["legal"], bool)
    raw = out["search_scores"]
    if legal.shape != (n, 4) or len(raw) != n:
        raise AssertionError(f"depth {depth}: answer for {len(raw)} boards, expected {n}")
    scores = np.array([[np.nan if v is None else v for v in row] for row in raw])
    if not np.array_equal(~np.isnan(scores), legal):
        raise AssertionError(f"depth {depth}: search_scores None where legal or "
                             "a number where illegal")
    if not np.isfinite(scores[legal]).all():
        raise AssertionError(f"depth {depth}: non-finite score of a legal move")
    actions = np.asarray(out["actions"])
    live = legal.any(1)
    if not legal[live, actions[live]].all():
        raise AssertionError(f"depth {depth}: an illegal action was served")
    if not np.array_equal(actions[live], np.nanargmax(scores[live], 1)):
        raise AssertionError(f"depth {depth}: the action is not the argmax of the scores")
    return scores


def assert_close(name: str, got: np.ndarray, want: np.ndarray, tol: float) -> float:
    """Raise unless ``got`` is within ``tol`` (rtol and atol) of ``want``, NaN
    where it is; return the largest absolute difference."""
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        raise AssertionError(f"{name}: NaN (None) in other places")
    ok = ~np.isnan(want)
    if not np.allclose(got[ok], want[ok], rtol=tol, atol=tol):
        raise AssertionError(f"{name}: max |diff| {np.abs(got[ok] - want[ok]).max()} "
                             f"beyond rtol=atol={tol}")
    return float(np.abs(got[ok] - want[ok]).max()) if ok.any() else 0.0


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def search_phase(svc: PolicyService, by_phase: dict) -> None:
    """Serve by expectimax at depths 1-3 on ``svc``'s device, against a CPU
    copy of the service at depths 1 and 2 and against one chunk at depth 3;
    adds each depth's merge launches to ``by_phase``."""
    t0 = time.perf_counter()
    start = merge.launches
    cpu_svc = PolicyService(str(CHECKPOINT), device="cpu")
    boards = np.minimum(random_boards(np.random.default_rng(9), SEARCH_BATCHES[1]), 11)
    search_ms, search_err = {}, 0.0
    for depth, n in SEARCH_BATCHES.items():
        before = merge.launches
        t1 = time.perf_counter()
        out = svc.predict(boards[:n], search=depth)
        sync(svc.device)
        search_ms[depth] = (time.perf_counter() - t1) * 1e3
        scores = check_search_answer(out, n, depth)
        if depth < 3:
            mine = svc.predict(boards[:SEARCH_CPU_BOARDS], search=depth)
            theirs = cpu_svc.predict(boards[:SEARCH_CPU_BOARDS], search=depth)
            search_err = max(search_err, assert_close(
                f"depth {depth}, card vs CPU",
                check_search_answer(mine, SEARCH_CPU_BOARDS, depth),
                check_search_answer(theirs, SEARCH_CPU_BOARDS, depth), SEARCH_TOL))
        else:
            chunk = svc.DEPTH3_CHUNK
            if n <= chunk:
                raise AssertionError(f"{n} boards do not cross the {chunk}-board chunk")
            first = check_search_answer(svc.predict(boards[:chunk], search=depth),
                                        chunk, depth)
            search_err = max(search_err, assert_close(
                f"depth 3, first {chunk} of {n} vs {chunk} alone", scores[:chunk],
                first, SEARCH_TOL))
        by_phase[f"search_d{depth}"] = merge.launches - before
    del cpu_svc
    phase("search", t0, f"{CHECKPOINT.name}: search_scores finite exactly where legal, "
          f"actions legal and their argmax, at depths 1/2/3 on "
          f"{'/'.join(map(str, SEARCH_BATCHES.values()))} boards; card == CPU on "
          f"{SEARCH_CPU_BOARDS} boards at depths 1 and 2, depth-3 chunks == one "
          f"request, to {SEARCH_TOL} (max |diff| {search_err:.6g}); host ms per request "
          + ", ".join(f"depth {d} {ms:.3f}" for d, ms in search_ms.items())
          + "; merge launches " + ", ".join(f"depth {d} {by_phase[f'search_d{d}']}"
                                            for d in SEARCH_BATCHES)
          + f" (all {merge.launches - start}, with the comparisons' card requests)")


def search_eval_phase(by_phase: dict, device="cuda") -> None:
    """The CLI's search evaluation at depth 2 of SEARCH_EVAL_CHECKPOINT."""
    t0 = time.perf_counter()
    before = merge.launches
    m = evaluate_checkpoint(str(SEARCH_EVAL_CHECKPOINT), games=SEARCH_EVAL_GAMES,
                            env_seed=12345, search=True, search_depth=2, device=device)
    sync(device)
    seconds = time.perf_counter() - t0
    by_phase["search_eval"] = merge.launches - before
    if m["avg_score"] <= SEARCH_EVAL_MIN_AVG:
        raise AssertionError(f"depth-2 search avg {m['avg_score']} <= {SEARCH_EVAL_MIN_AVG}")
    phase("search_eval", t0, f"{SEARCH_EVAL_CHECKPOINT.name} depth 2, n={SEARCH_EVAL_GAMES}: "
          f"avg {m['avg_score']}, max {m['max_score']}, median {m['median_score']}, "
          f"pct_2048 {m['pct_2048']}, moves {m['steps']}, "
          f"{seconds * 1e3 / m['steps']:.3f} ms per move, merge launches "
          f"{by_phase['search_eval']} ({by_phase['search_eval'] / m['steps']:.2f} per move)")


def urm_phase(by_phase: dict, device="cuda") -> None:
    """The URM checkpoint: blocks and forward against the CPU, greedy eval."""
    t0 = time.perf_counter()
    before = merge.launches
    urm, ucfg, utype = load_model_checkpoint(str(URM_CHECKPOINT), device=device)
    urm_cpu, _, _ = load_model_checkpoint(str(URM_CHECKPOINT), device="cpu")
    if utype != "urm":
        raise AssertionError(f"{URM_CHECKPOINT.name} loaded as {utype!r}")
    ub = torch.as_tensor(np.minimum(random_boards(np.random.default_rng(11), URM_BATCH), 11))
    with torch.inference_mode():
        hidden = torch.as_tensor(np.random.default_rng(12).normal(
            size=(URM_BATCH, 16, ucfg.hidden_dim)).astype(np.float32))
        block_err = max(assert_close(
            f"URM block {i}", urm._block(urm.blocks[i], hidden.to(device)).cpu().numpy(),
            urm_cpu._block(urm_cpu.blocks[i], hidden).numpy(), URM_BLOCK_TOL)
            for i in range(ucfg.num_layers))
        got = urm(encode_boards(ub.to(device)))
        want = urm_cpu(encode_boards(ub))
        fwd_err = max(assert_close(f"URM forward {name}", g.cpu().numpy(), w.numpy(),
                                   URM_FORWARD_TOL)
                      for name, g, w in zip(("logits", "value"), got, want))
    t1 = time.perf_counter()
    m = run_eval(urm, URM_GAMES, seed=0, max_steps=EVAL_MAX_STEPS, greedy=True,
                 env_seed=12345)
    sync(device)
    urm_seconds = time.perf_counter() - t1
    by_phase["urm"] = merge.launches - before
    if m["avg_score"] <= URM_MIN_AVG:
        raise AssertionError(f"URM greedy avg {m['avg_score']} <= {URM_MIN_AVG}")
    if by_phase["urm"] < m["steps"]:
        raise AssertionError(f"{by_phase['urm']} merge launches for {m['steps']} steps")
    phase("urm", t0, f"{URM_CHECKPOINT.name} {ucfg}: blocks == CPU to {URM_BLOCK_TOL} "
          f"(max |diff| {block_err:.3g}), forward on {URM_BATCH} boards == CPU to "
          f"{URM_FORWARD_TOL} (max |diff| {fwd_err:.3g}); greedy n={URM_GAMES}: avg "
          f"{m['avg_score']}, max {m['max_score']}, median {m['median_score']}, "
          f"pct_2048 {m['pct_2048']}, steps {m['steps']}, {urm_seconds:.3f} s "
          f"({urm_seconds * 1e3 / m['steps']:.3f} ms per step), merge launches "
          f"{by_phase['urm']}")


def learner_card_vs_cpu(cfg, state_dict: dict, opt_state, traj) -> str:
    """One learner minibatch of LEARNER_ROWS real rows of ``traj`` and a plan
    of LEARNER_SLOTS slots, schedule multiplier 1, on the card and on a CPU
    copy from the same parameters, optimizer state, plan and shuffle;
    raises beyond LEARNER_RTOL / LEARNER_ATOL."""
    device = traj.valid.device
    adv = A.compute_packed(traj.points, traj.mono_before, traj.mono_after,
                           traj.empt_before, traj.empt_after, traj.value_pred,
                           traj.valid, traj.done_here, traj.boot_value,
                           cfg.reward_weights, cfg.gamma, A.RtgMoments.initial(device),
                           cfg.rtg_beta, 1)

    def rows(x):
        return x.reshape((-1,) + x.shape[2:])[:LEARNER_ROWS].cpu()

    gen = torch.Generator().manual_seed(7)
    plan = AUG.plan(gen, LEARNER_SLOTS, torch.tensor(LEARNER_SLOTS),
                    torch.ones(LEARNER_ROWS, dtype=torch.bool))
    ds = U.Dataset(board_before=rows(traj.board_before), action=rows(traj.action).long(),
                   action_mask=rows(traj.action_mask), advantage=rows(adv["advantage"]),
                   G_norm=rows(adv["G_norm"]), logprobs=rows(traj.logprobs),
                   valid=torch.cat([torch.ones(LEARNER_ROWS, dtype=torch.bool), plan.valid]),
                   aug_src=plan.src, aug_tf=plan.transform)
    perm = torch.rand(1, ds.valid.shape[0], generator=gen)

    def run(dev):
        _, model, _ = loop.build_model(cfg)
        model.load_state_dict(state_dict)
        model.to(dev).eval()
        st = opt.OptState(*({k: v.to(dev, copy=True) for k, v in part.items()} for part in
                            (opt_state.momentum, opt_state.m, opt_state.v)), opt_state.step)
        fn = U.make_optimize_fn(model, param_labels(model), opt.OptimizerConfig(
            learning_rate=cfg.learning_rate, critic_lr=cfg.critic_lr), cfg.batch_size, 1,
            kl_diagnostic=False)
        stats = fn(st, U.Dataset(*(None if x is None else x.to(dev) for x in ds)),
                   cfg.entropy_strength, cfg.critic_strength, np.float32(1.0),
                   perm_draws=perm.to(dev))
        return stats, {n: p.detach().cpu() for n, p in model.named_parameters()}

    (card, card_p), (cpu, cpu_p) = run(device), run("cpu")
    if float(card.num_batches) != 1.0:
        raise AssertionError(f"{float(card.num_batches)} minibatches, expected 1")
    for name in ("loss", "grad_norm"):
        g, w = float(getattr(card, name)), float(getattr(cpu, name))
        if not abs(g - w) <= LEARNER_RTOL * abs(w):
            raise AssertionError(f"learner {name}: card {g} vs CPU {w}")
    err = 0.0
    for n, w in cpu_p.items():
        d = float((card_p[n] - w).abs().max())
        if d > LEARNER_ATOL:
            raise AssertionError(f"learner {n}: card vs CPU max |diff| {d} > {LEARNER_ATOL}")
        err = max(err, d)
    moved = max(float((cpu_p[n] - state_dict[n]).abs().max()) for n in cpu_p)
    return (f"learner minibatch card == CPU: loss {float(card.loss):.7g} vs "
            f"{float(cpu.loss):.7g}, grad norm {float(card.grad_norm):.7g} vs "
            f"{float(cpu.grad_norm):.7g} (rtol {LEARNER_RTOL}); params max |diff| "
            f"{err:.3g} (atol {LEARNER_ATOL}; largest move of a weight {moved:.3g})")


def train_phase(by_phase: dict, device="cuda") -> None:
    """A fresh 3-step run of the expG recipe through the CLI's configuration
    and the trainer, then the learner card against CPU."""
    t0 = time.perf_counter()
    before = merge.launches
    with tempfile.TemporaryDirectory() as tmp:
        cfg = cli.train_config(TRAIN_RECIPE + ["--steps", str(TRAIN_STEPS),
                                               "--checkpoint-dir", tmp, "--device", device])
        key = np.array([0, cfg.seed], np.uint32)
        _, init_model, _ = loop.build_model(cfg, loop.make_generator("cpu", *key, loop.INIT))
        init = {n: p.detach().clone() for n, p in init_model.named_parameters()}
        steps, marks = [], [merge.launches]

        def on_step(info):
            sync(device)
            marks.append(merge.launches)
            rec = dict(step=info["step"], scalars=info["scalars"],
                       rollout_s=info["rollout_s"], learner_s=info["learner_s"],
                       launches=marks[-1] - marks[-2],
                       params={n: p.detach().cpu().clone()
                               for n, p in info["model"].named_parameters()})
            if info["step"] == 0:
                st = info["opt_state"]
                rec["first"] = (
                    {n: p.detach().cpu().clone() for n, p in info["model"].state_dict().items()},
                    opt.OptState(*({k: v.clone() for k, v in part.items()}
                                   for part in (st.momentum, st.m, st.v)), st.step),
                    info["traj"])
            steps.append(rec)

        summary = loop.train(cfg, on_step=on_step)
    by_phase["train"] = merge.launches - before
    if [s["step"] for s in steps] != list(range(TRAIN_STEPS)):
        raise AssertionError(f"steps run: {[s['step'] for s in steps]}")
    for n, p in steps[0]["params"].items():
        if not torch.equal(p, init[n]):
            raise AssertionError(f"step 1 (warmup multiplier 0) changed {n}")
    for i in (1, 2):
        if all(torch.equal(steps[i]["params"][n], steps[i - 1]["params"][n]) for n in init):
            raise AssertionError(f"step {i + 1} changed no parameter")
    for s in steps:
        sc = s["scalars"]
        bad = [k for k, v in sc.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"step {s['step'] + 1}: non-finite {bad}")
        if sc["env_steps"] != ENV_STEPS_PER_STEP:
            raise AssertionError(f"step {s['step'] + 1}: {sc['env_steps']} env steps")
        rows = sc["samples"] + sc["augmented_samples"]
        if sc["num_batches"] != math.ceil(rows / cfg.batch_size):
            raise AssertionError(f"step {s['step'] + 1}: {sc['num_batches']} minibatches "
                                 f"for {rows} rows")
        if s["launches"] != MERGES_PER_STEP:
            raise AssertionError(f"step {s['step'] + 1}: {s['launches']} merge launches")
    state_dict, opt_state, traj = steps[0]["first"]
    n_legal = (~traj.action_mask).sum(-1).to(torch.float32)
    uniform = float(n_legal.log().mean())
    rollout_gap = float((traj.entropy - n_legal.log()).abs().max())
    first_entropy = steps[0]["scalars"]["entropy"]
    if rollout_gap > 1e-5 or abs(first_entropy - uniform) > 0.02:
        raise AssertionError(f"first policy not uniform over legal moves: rollout gap "
                             f"{rollout_gap}, learner entropy {first_entropy} vs {uniform}")
    check = learner_card_vs_cpu(cfg, state_dict, opt_state, traj)
    per_step = "; ".join(
        f"step {s['step'] + 1}: rollout {s['rollout_s']:.3f} s, learner {s['learner_s']:.3f} s, "
        f"{ENV_STEPS_PER_STEP / (s['rollout_s'] + s['learner_s']):.0f} env steps/s, "
        f"{s['scalars']['num_batches']:.0f} minibatches, entropy {s['scalars']['entropy']:.4f}, "
        f"avg completed episode {s['scalars']['batch_avg_score']:.1f}"
        for s in steps)
    phase("train", t0, f"expG recipe, {TRAIN_STEPS} fresh steps on the card: step 1 left "
          f"every parameter bit-identical, steps 2-3 moved them; scalars finite; "
          f"{ENV_STEPS_PER_STEP} env steps and ceil(S/{cfg.batch_size}) minibatches a step; "
          f"first policy uniform over legal moves (learner entropy {first_entropy:.5f} vs "
          f"{uniform:.5f}); {MERGES_PER_STEP} merge launches a step ({by_phase['train']} "
          f"in all); {per_step}; trained in {summary['elapsed']:.3f} s; {check}")


def train_resume_phase(by_phase: dict, device="cuda") -> None:
    """The JAX run's own step-19,999 state resumed on the card for 2 steps,
    with eval-in-train after each."""
    t0 = time.perf_counter()
    before = merge.launches
    with tempfile.TemporaryDirectory() as tmp:
        for f in ("train_state.npz", "train_state.json", "env_carry.npz", "env_carry.json"):
            shutil.copy(RESUME_SOURCE / f, tmp)
        with np.load(RESUME_SOURCE / "env_carry.npz") as z:
            carried = torch.as_tensor(z["['boards']"])
        cfg = cli.train_config(TRAIN_RECIPE + [
            "--steps", str(RESUME_STEPS), "--resume", "--checkpoint-dir", tmp,
            "--log-dir", tmp, "--eval-freq", "1", "--eval-games", str(RESUME_EVAL_GAMES),
            "--device", device])
        steps = []

        def on_step(info):
            traj = info["traj"]
            done = traj.done_here
            steps.append(dict(
                step=info["step"], first=traj.board_before[0].cpu(),
                score_sum=float(traj.ep_score[done].to(torch.float64).sum()),
                episodes=int(done.sum()), rollout_s=info["rollout_s"],
                learner_s=info["learner_s"], scalars=info["scalars"],
                params={n: p.detach().cpu().clone()
                        for n, p in info["model"].named_parameters()}))

        summary = loop.train(cfg, on_step=on_step)
        by_phase["train_resume"] = merge.launches - before
        evals = [json.loads(line) for f in Path(tmp).glob("*.jsonl")
                 for line in f.read_text().splitlines() if "eval/avg_score" in line]
        _, model, _ = loop.build_model(cfg)
        _, _, _, manifest = loop.load_train_state(tmp, model, "cpu")
        final = {n: p.detach() for n, p in model.named_parameters()}
    if [s["step"] for s in steps] != [20000, 20001]:
        raise AssertionError(f"resumed steps {[s['step'] for s in steps]}, expected 20000-20001")
    if not torch.equal(steps[0]["first"], carried):
        raise AssertionError("the first chunk did not start from the 512 carried boards")
    episodes = sum(s["episodes"] for s in steps)
    episode_avg = sum(s["score_sum"] for s in steps) / max(episodes, 1)
    if episodes == 0 or episode_avg <= RESUME_MIN_EPISODE_AVG:
        raise AssertionError(f"{episodes} completed episodes, avg {episode_avg} <= "
                             f"{RESUME_MIN_EPISODE_AVG}")
    if [e["step"] for e in evals] != [20000, 20001]:
        raise AssertionError(f"evals at steps {[e['step'] for e in evals]}")
    for e in evals:
        if e["eval/avg_score"] <= RESUME_MIN_EVAL_AVG:
            raise AssertionError(f"eval at step {e['step']}: avg {e['eval/avg_score']} <= "
                                 f"{RESUME_MIN_EVAL_AVG}")
    if manifest["train_step"] != RESUME_STEPS - 1:
        raise AssertionError(f"saved train_state is at step {manifest['train_step']}")
    for n, p in final.items():
        if not torch.equal(p, steps[-1]["params"][n]):
            raise AssertionError(f"the saved step-{RESUME_STEPS - 1} train_state differs at {n}")
    phase("train_resume", t0, f"{RESUME_SOURCE.name} (JAX-written, step 19,999) resumed "
          f"at step 20000 on its 512 carried boards, {len(steps)} steps: {episodes} "
          f"completed episodes, avg {episode_avg:.1f} (floor {RESUME_MIN_EPISODE_AVG}); "
          "sampled evals of " f"{RESUME_EVAL_GAMES} games: "
          + ", ".join(f"step {e['step']} avg {e['eval/avg_score']} max "
                      f"{e['eval/max_score']} pct_2048 {e['eval/pct_2048']}" for e in evals)
          + f" (floor {RESUME_MIN_EVAL_AVG}); step-{RESUME_STEPS - 1} train_state read back "
          f"equal; " + "; ".join(
              f"step {s['step']}: rollout {s['rollout_s']:.3f} s, learner "
              f"{s['learner_s']:.3f} s, sched_mult {s['scalars']['sched_mult']:.3g}"
              for s in steps)
          + f"; {summary['elapsed']:.3f} s in all; merge launches {by_phase['train_resume']}")


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

    by_phase = {"serve": serve_launches, "eval": eval_launches}

    search_phase(svc, by_phase)
    search_eval_phase(by_phase)
    urm_phase(by_phase)
    train_phase(by_phase)
    train_resume_phase(by_phase)

    # 13. kernels
    t0 = time.perf_counter()
    main_launches = merge.launches
    if main_launches != sum(by_phase.values()):
        raise AssertionError(f"{main_launches} launches, phases add up to {by_phase}")
    t = timing[SERVE_BATCH]
    kernels = [{
        "name": "merge4", "route": "cuda",
        "source": "tpu2048_torch/ops/csrc/merge4.cu",
        "replaces": "tpu2048/ops/pallas_merge.py:129",
        "launches": main_launches, "max_abs_err": max(max_err, graph_err),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "launches_by_phase": by_phase,
        "enqueue_ms": t["enqueue_ms"], "floor_ms": t["floor_ms"],
        "by_n": {str(n): {"ms": v["ms"], "enqueue_ms": v["enqueue_ms"],
                          "floor_ms": v["floor_ms"], "bound_ms": v["bound_ms"]}
                 for n, v in timing.items()},
    }]
    phase("kernels", t0, f"merge4: bit-exact, {main_launches} launches on the "
          "main path (" + ", ".join(f"{k} {v}" for k, v in by_phase.items()) + ")")
    print(json.dumps({"kernels": kernels}), flush=True)

    del svc, model
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
