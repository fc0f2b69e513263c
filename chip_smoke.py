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
  train    a fresh run of scripts/train_expG_packed_ppo.sh (MLP H=384x3,
           512 lanes x 256 steps, batch 4096, Muon+AdamW, adaptive entropy,
           best-episode capture, viz export), 3 steps printing every step:
           step 1 (warmup multiplier 0) leaves every parameter bit-identical
           and steps 2-3 change them; every scalar finite; 131,072 env steps
           and ceil(S/4096) minibatches a step; the first policy uniform over
           the legal moves; 512 rollout merge launches a step plus the
           episode fetches'; a breakdown printed and viz JSON with the
           committed file's keys. Then one learner minibatch on the step-1
           chunk, on the card and on a CPU copy (same parameters, optimizer
           state, plan and shuffle): loss and gradient norm to LEARNER_RTOL,
           new parameters to LEARNER_ATOL; the step-1 recorder against its
           CPU replay from the same records, bit for bit; the recorded
           episode replayed through the plain engine
  train_resume  a copy of checkpoints_expG's train_state and env_carry
           (JAX-written, step 19,999) resumed for 2 steps of the same
           recipe (its eval of 128 sampled games at step 20000): it starts
           on the 512 carried boards, its completed episodes and its eval
           clear floors fixed before the first run, its step-20001
           train_state reads back, the JAX run's recorded best episode is
           restored and kept in the env_carry it writes, and replays
           through the plain engine
  train_dp  the data-parallel step (train/loop.py's make_sharded_train_step
           over a tpu2048_torch/parallel/ process group) of the same
           recipe and state at its full width, steps 20000-20001: (a) one
           NCCL rank against the step without a group (counts exact,
           moments to 1e-6, parameters to 1e-4); (b) two spawned ranks
           sharing the card over Gloo, 256 lanes and a 2,048 batch each:
           parameters bit-identical on both after each step, 131,072 env
           steps, the moments equal to a host recomputation over both
           ranks' records (1e-4), fresh lanes' completed episodes above a
           floor, 1,024 merge launches a rank; (c) the same over NCCL, one
           rank a card, when the machine has two cards. Host seconds a step
           (beside train_resume's), collectives and their bytes and host ms
  train_urm  a copy of checkpoints_urm_r5 (the URM, step 449, 4,096 lanes)
           resumed for 2 steps of scripts/train_urm_long.sh with one eval
           of 32 sampled games: completed episodes and the eval above
           floors, the step-450 train_state read back, the recorded episode
           kept, a URM learner minibatch card == CPU
  train_exact  a copy of checkpoints_expA's train_state (exact episodes,
           step 19,999) resumed for 2 steps of scripts/train_expA2.sh (512
           games a step, cap 2048): the batch average and the eval of 256
           games above floors, env_steps the sum of the games' moves, the
           trips each step ran
  train_expert  a copy of checkpoints_expF's train_state (the JAX run's
           expert-iteration student, H=384x3, step 200) resumed for 2 steps
           of scripts/train_expF_wide.sh (frozen depth-2 expA teacher, bf16
           leaves, 32 games, 16 expert-driven), each rollout capped at
           EXPERT_MAX_STEPS trips: the teacher's calibration printed, its
           card scores of the first trips' boards == the CPU's, the labels
           the CPU's argmax but for near-ties, the expert envs' moves, soft
           targets that sum to 1, an imitation-sharp learner minibatch card
           == CPU, the merge launches of each step (trips x the search's and
           the step's, + 1), the recipe's 256-game eval above a floor
  train_expert_live  checkpoints_expA's train_state resumed for 1 step of
           scripts/train_expC_ei.sh (the live teacher) with --anchor-kl 0.5,
           capped as above: the live coefs card == CPU, a learner minibatch
           with the anchor card == CPU, the 256-game eval above a floor
  export_demo  the CLI's export-demo into temporary directories: (a) the
           sampled best of 16 games of checkpoints_expG, (b) depth-1 search
           play of 8 games of checkpoints_expA, (c) checkpoints_urm_r5 with
           --game (a)'s best_game.json: model.onnx, model_weights.json and
           model_config.json byte-equal to an export of the checkpoint
           loaded on the CPU; every move of each best game replayed through
           the plain engine, its points adding up to its score; the best
           games above floors fixed before the first run
  play     watch_agent(checkpoints_expA, search=1) for one game: it ends
           with no legal move, every move legal, the printed final score
           the board's; human_play on scripted keys ending with q; one merge
           launch a client move (+ the search's)
  warmstart  python -m tpu2048_torch.train.warmstart from checkpoints_expA
           (the expD recipe's prerequisite flags) at expert depths 0 and 1:
           each train_state read back by the port trainer's loader, at step
           100, with finite moments, sigma > 0, a zero optimizer state, the
           key [0, 20260818] and the source's parameters
  models   python -m tpu2048_torch.models on the card: shapes, finite
           logits, the JAX package's parameter counts
  scaling  scripts/torch_bench_scaling.py at the JAX harness's defaults
           (MLP H=196x2, 64 games or lanes a rank), exact and packed, D=1
           (in this process) and D=2 (two spawned ranks) in one call: on one
           card every rank on it over Gloo, which measures no scaling; on a
           machine of two one a card over NCCL. Env steps/s of 3 timed steps
           after 2 warm-up ones, each from the initial parameters, their
           spread, the efficiency against D=1, each row's merge launches and
           env steps against its steps' trips
  prune_bias  scripts/torch_prune_bias.py on checkpoints_expA at depth 3,
           32 boards of its greedy games: the moves top-k pruning (k = 2, 3)
           changes and the root scores' shift; scores finite exactly where
           legal, no pruned score above the exact one, the peak memory
           within the printed cap, the first board's k=2 scores == the
           CPU's, the searches' merge launches exact
  kernels  one JSON line per the port's kernels: check, launches (by
           phase), times (at the served batch, and per timed N with the
           launch floor and the host enqueue)

The kernel launch counts are set to 0 just before the serve phase and read
after the prune_bias phase: they count the main path only (the spawned
ranks of train_dp and scaling count in their own processes and report
theirs). The last line is
{"ok": true, "device": {...}}. Imports torch, numpy, the standard library and
the port; never JAX and never the tpu2048 package.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import hashlib
import io
import json
import math
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from tpu2048_torch import DIRECTION_NAMES
from tpu2048_torch.algo import advantage as A
from tpu2048_torch.algo import augment as AUG
from tpu2048_torch.algo import capture
from tpu2048_torch.algo import update as U
from tpu2048_torch.algo.search import NUM_SPAWNS, expectimax_scores
from tpu2048_torch.env import engine
from tpu2048_torch.models.encoding import encode_boards
from tpu2048_torch.ops import merge
from tpu2048_torch.ops import optimizer as opt
from tpu2048_torch.parallel import mesh as pmesh
from tpu2048_torch.serve import PolicyService
from tpu2048_torch.models import __main__ as models_main
from tpu2048_torch.train import cli
from tpu2048_torch.train import loop
from tpu2048_torch.train import play_cli
from tpu2048_torch.train import warmstart
from tpu2048_torch.train.export import export_demo_assets
from tpu2048_torch.train.evaluate import (evaluate_checkpoint, load_model_checkpoint,
                                          load_search_coefs, run_eval)
from tpu2048_torch.utils.profiling import device_ms
from scripts import torch_bench_scaling as bench_scaling
from scripts import torch_prune_bias as prune_bias

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
# The recipes of scripts/ as the smoke runs them: each script's flags but
# for --steps, the directories, --print-freq and --resume, which each phase
# adds (and, for the URM, the eval cadence and size its phase states).
# scripts/train_expG_packed_ppo.sh: packed, best-episode capture on.
TRAIN_RECIPE = [
    "--packed", "--lanes", "512", "--horizon", "256", "--batch-size", "4096",
    "--lr", "1e-3", "--critic-lr", "1e-4", "-H", "384", "--num-layers", "3",
    "--gamma", "0.995", "--dropout", "0.0", "--entropy", "0.02", "--adaptive-beta",
    "--target-entropy", "0.25", "--beta-min", "0.001", "--beta-max", "0.05",
    "--beta-lr", "0.005", "--points", "0.10", "--mono", "1.0", "--critic", "0.2",
    "--rtg-beta", "0.99", "--warmup-steps", "20", "--upsample-ratio", "0.25",
    "-t", "mlp", "--no-kl-diagnostic", "--eval-freq", "250", "--eval-games", "128",
    "--checkpoint-freq", "250", "--scan-cap", "2560"]
# scripts/train_urm_long.sh: the packed URM, 4,096 lanes x 128.
URM_RECIPE = [
    "--packed", "--lanes", "4096", "--horizon", "128", "--batch-size", "8192",
    "-t", "urm", "-H", "64", "--num-layers", "2", "--num-heads", "4", "--num-loops", "4",
    "--truncated-loops", "1", "--lr", "1e-3", "--critic-lr", "1e-4", "--gamma", "0.99",
    "--entropy", "0.02", "--dropout", "0.0", "--points", "0.10", "--mono", "1.0",
    "--critic", "0.2", "--rtg-beta", "0.99", "--warmup-steps", "10",
    "--upsample-ratio", "0.25", "--no-kl-diagnostic", "--eval-freq", "20",
    "--eval-games", "128", "--checkpoint-freq", "10", "--scan-cap", "2560"]
# scripts/train_expA2.sh: exact episodes, 512 games a step.
EXACT_RECIPE = [
    "--episodes", "512", "--batch-size", "4096", "--lr", "5e-4", "--critic-lr", "3e-4",
    "-H", "196", "--gamma", "0.995", "--entropy", "0.02", "--adaptive-beta",
    "--target-entropy", "0.25", "--beta-min", "0.001", "--beta-max", "0.05",
    "--beta-lr", "0.005", "--points", "0.10", "--mono", "1.0", "--critic", "0.2",
    "--rtg-beta", "0.99", "--warmup-steps", "10", "--upsample-ratio", "0.25", "-t", "mlp",
    "--no-kl-diagnostic", "--eval-freq", "100", "--eval-games", "256",
    "--checkpoint-freq", "100", "--scan-cap", "2048"]
TRAIN_STEPS = 3
ENV_STEPS_PER_STEP = 512 * 256
MERGES_PER_STEP = 2 * 256  # all_moves of the boards, then of the next boards
# The keys of the committed viz_data_expG/step_000000.json (top level, a
# move, its rewards), held here because the smoke also runs from copies of
# the repository without its data directories; tests/test_torch_printing.py
# holds these to the file.
VIZ_KEYS = (("step", "score", "total_steps", "moves"),
            ("step", "state_before", "action", "state_after", "points_earned", "rewards",
             "entropy", "advantage"),
            ("points", "smoothness", "tile_bonus", "corner", "adjacency", "chain",
             "monotonicity", "topological", "emptiness"))
# One learner minibatch, card against CPU: f32 GEMMs summed in another order
# and bf16 Newton-Schulz products rounded on other units.
LEARNER_ROWS, LEARNER_SLOTS = 3072, 512  # + 2 x 512 planned rows: one minibatch
LEARNER_RTOL = 1e-4
LEARNER_ATOL = 1e-4
RESUME_SOURCE = ROOT / "checkpoints_expG"  # step 19,999 of the JAX run
RESUME_STEPS = 20002
# Floors fixed before the first card run. The JAX run's EMA of the completed
# episodes' average at step 19,999 is 22,716 (TPU, train_state.json), and
# its lr is about 0 this near the end of the cosine schedule.
RESUME_MIN_EPISODE_AVG = 15000
RESUME_MIN_EVAL_AVG = 12000
URM_SOURCE = ROOT / "checkpoints_urm_r5"  # step 449 of the JAX run
URM_STEPS = 452
URM_EVAL = ["--eval-freq", "10", "--eval-games", "32"]  # one eval, at step 450
# Floors fixed before the first card run of this phase. The JAX run's last
# five evals: 6,897-8,558 at n=128; its EMA of completed episodes 2,091
# (TPU, train_state.json; an EMA of decay 0.001 over 450 steps that started
# at 0 and at the first policy's scores).
URM_MIN_EPISODE_AVG = 3500
URM_MIN_EVAL_AVG = 3500
# The URM learner check on 2,048 rows and 2 x 512 planned ones: fewer than
# the recipe's batch of 8,192, so one shorter minibatch, which bounds the
# CPU's share of the phase.
URM_LEARNER_ROWS, URM_LEARNER_SLOTS = 2048, 512
EXACT_SOURCE = ROOT / "checkpoints_expA"  # step 19,999 of the JAX run
EXACT_STEPS = 20002
# Floors fixed before the first card run of this phase. The JAX run's best
# eval: 8,848 at n=256; its EMA of the batch average 8,272 (TPU,
# train_state.json).
EXACT_MIN_BATCH_AVG = 5000
EXACT_MIN_EVAL_AVG = 4500
# scripts/train_expF_wide.sh: expert iteration, exact episodes (32 games, 16
# of them expert-driven), the frozen depth-2 expA teacher with bf16 leaves.
EXPERT_RECIPE = [
    "--episodes", "32", "--batch-size", "4096", "--lr", "1e-3", "--critic-lr", "1e-3",
    "-H", "384", "--num-layers", "3", "--gamma", "0.995", "--entropy", "0.001",
    "--dropout", "0.0", "--points", "0.10", "--mono", "1.0", "--critic", "1.0",
    "--rtg-beta", "0.9", "--warmup-steps", "20", "--upsample-ratio", "0.25", "-t", "mlp",
    "--no-kl-diagnostic", "--expert-iter", "--expert-depth", "2", "--expert-mix", "0.5",
    "--expert-bf16", "--expert-src", str(ROOT / "checkpoints_expA"), "--decouple-critic",
    "--print-freq", "100", "--eval-freq", "25", "--eval-games", "256",
    "--checkpoint-freq", "25", "--scan-cap", "2560"]
# scripts/train_expC_ei.sh (the live teacher: the policy itself, coefs from
# its moments) without --decouple-critic (expA's state has a shared trunk),
# with scripts/train_expE_dagger.sh's --anchor-kl 0.5.
EXPERT_LIVE_RECIPE = [
    "--episodes", "32", "--batch-size", "4096", "--lr", "5e-5", "--critic-lr", "8e-4",
    "-H", "196", "--gamma", "0.995", "--entropy", "0.001", "--points", "0.10", "--mono",
    "1.0", "--critic", "1.0", "--rtg-beta", "0.9", "--warmup-steps", "5",
    "--upsample-ratio", "0.25", "-t", "mlp", "--no-kl-diagnostic", "--expert-iter",
    "--expert-depth", "2", "--expert-mix", "0.5", "--print-freq", "100", "--eval-freq", "25",
    "--eval-games", "256", "--checkpoint-freq", "25", "--scan-cap", "2560",
    "--anchor-kl", "0.5"]
# A verbatim step runs until its longest game ends: expert games last
# 1,300-2,560 moves at about 0.1 s of host time a move, minutes a step. The
# phases cap the rollout at this many trips (--max-steps), which keeps every
# width and the 32 games; the profile measures a whole step.
EXPERT_MAX_STEPS = 128
EXPERT_SOURCE = ROOT / "checkpoints_expF"  # step 200 of the JAX run
EXPERT_STEPS = 203  # steps 201-202
EXPERT_LIVE_STEPS = 20001  # checkpoints_expA's step 20000
# The card's depth-2 search scores of the first trips' boards against the
# CPU's (the same teacher and bf16 leaves, the plain merge): f32 sums over
# 32 spawn slots a level, in another order.
EXPERT_CHECK_TRIPS = 2
# Floors fixed before the first card run. expF: the JAX run's best eval at
# step 200 2,062.58 at n=256, its EMA of completed episodes 2,264 (TPU,
# checkpoints_expF/*.json). The live phase: train_exact's floor (lr 5e-5
# near the end of its schedule barely moves expA's policy).
EXPERT_MIN_EVAL_AVG = 1000
EXPERT_LIVE_MIN_EVAL_AVG = 4500
# The demo export (the CLI's export-demo): sampled best-of on expG, depth-1
# search play on expA, and the URM with --game (the sampled run's game).
# Floors on the best game, fixed before the first card run: expG greedy
# averages 25,985.6875 over 256 games on the card; expA at depth 1
# averages 8,949 with a median of 7,524 (the JAX package, TPU, BENCH.md).
DEMO_SAMPLED = ROOT / "checkpoints_expG"
DEMO_SAMPLED_GAMES = 16
DEMO_SAMPLED_MIN_BEST = 15000
DEMO_SEARCH = ROOT / "checkpoints_expA"
DEMO_SEARCH_GAMES = 8
DEMO_SEARCH_MIN_BEST = 5000
DEMO_URM = ROOT / "checkpoints_urm_r5"
DEMO_ASSETS = ("model.onnx", "model_weights.json", "model_config.json")
# The terminal clients: one game of expA by depth-1 search, and a human
# game of scripted keys (an unknown key among them) that ends with q.
PLAY_SOURCE = ROOT / "checkpoints_expA"
HUMAN_KEYS = [*"wasdwasdx", "\x1b[A", "\x1b[D", "\x1b[B", "\x1b[C", *"ddsaawsd", "q"]
# The warm start of the expC/D/E recipes' prerequisites
# (scripts/train_expD_frozen.sh), at expert depths 0 and 1.
WARMSTART_SOURCE = ROOT / "checkpoints_expA"
WARMSTART_FLAGS = ["--train-step", "100", "--gamma", "0.995", "--highest-score", "40520"]
WARMSTART_KEY = [0, 20260818]
# python -m tpu2048_torch.models: the JAX package's parameter counts.
MODELS_PARAMS = {"GameMLP": 11973, "GameURM": 81237}
# train_dp: the data-parallel step (over a tpu2048_torch/parallel/ group) at the expG
# recipe's full width, from checkpoints_expG's step-19,999 state, steps
# 20000-20001 at the saved entropy weight. (a) one NCCL rank against the
# step without a group: counts exact, moments to DP_SINGLE_RTOL, parameters
# to DP_SINGLE_ATOL (bf16 Newton-Schulz, as the learner check allows).
# (b) two Gloo ranks sharing the card, 256 lanes and a 2,048 batch each:
# parameters bit-identical, moments against a host recomputation over both
# ranks' records to DP_HOST_RTOL.
DP_STEPS = (20000, 20001)
DP_SINGLE_RTOL = 1e-6
DP_SINGLE_ATOL = 1e-4
DP_HOST_RTOL = 1e-4
DP_RANKS = 2
EXACT_SCALARS = ("samples", "augmented_samples", "batch_max_score", "pct_512", "pct_1024",
                 "pct_2048", "best_idx", "env_steps", "num_batches")
DP_RANK_TIMEOUT_S = 600
# Floor fixed before the first card run. The checkpoint's env_carry is of
# one rank (sharded_d 1), so two ranks start fresh boards, as the JAX
# package does, and complete only the games that end within 512 moves:
# half of what this phase's full-width rehearsal on the CPU averaged
# (5,402.3 over 42 episodes): a policy wrecked by a wrong step falls far below.
DP_MIN_EPISODE_AVG = 2500
# Merge launches the spawned ranks made on the main path, by phase: they
# count in their own processes.
REMOTE_LAUNCHES: dict = {}
# Host seconds of each step of train_resume, beside train_dp's.
STEP_SECONDS: dict = {}
# scaling: scripts/torch_bench_scaling.py at the JAX harness's defaults (64
# games or lanes a rank, exact games to 256 moves, packed horizon 256,
# minibatches of 128 rows a rank, MLP H=196x2), D = 1 and 2 in both modes in
# one call of its ``run``: on a machine of one card every rank on it over
# Gloo (D = 2 then measures no scaling), on a machine of two one a card over
# NCCL.
SCALING_MODES = ("exact", "packed")
SCALING_ENVS = 64
SCALING_HORIZON = 256
SCALING_REPEATS = 3
# prune_bias: scripts/torch_prune_bias.py on checkpoints_expA at depth 3:
# 32 boards of its greedy games (the JAX script's default is 64), the
# exact inner max against prune_k 2 and 3; the first board's k = 2 scores
# against a CPU copy of the model to SEARCH_TOL (the CPU takes seconds a
# board at depth 3: the exact search is held to the JAX package's on the
# CPU by tests/test_torch_prune_bias.py).
PRUNE_CHECKPOINT = ROOT / "checkpoints_expA"
PRUNE_BOARDS = 32
PRUNE_DEPTH = 3


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


def learner_card_vs_cpu(cfg, state_dict: dict, opt_state, traj, n_rows: int = LEARNER_ROWS,
                        n_slots: int = LEARNER_SLOTS) -> str:
    """One learner minibatch of the first ``n_rows`` valid rows of ``traj``
    (packed or exact) and a plan of ``n_slots`` slots, schedule multiplier 1,
    with ``cfg``'s objective (PPO, or imitation with the rollout's targets)
    and its anchor (a frozen copy of the same parameters, under
    --anchor-kl), on the card and on a CPU copy of ``cfg``'s model from the
    same parameters, optimizer state, plan and shuffle; raises beyond
    LEARNER_RTOL / LEARNER_ATOL. Dropout is turned off: the two sides would
    draw different masks."""
    device = traj.valid.device
    fields = (traj.points, traj.mono_before, traj.mono_after, traj.empt_before,
              traj.empt_after, traj.value_pred, traj.valid)
    if cfg.packed:
        adv = A.compute_packed(*fields, traj.done_here, traj.boot_value, cfg.reward_weights,
                               cfg.gamma, A.RtgMoments.initial(device), cfg.rtg_beta, 1)
    else:
        adv = A.compute(*fields, cfg.reward_weights, cfg.gamma, A.RtgMoments.initial(device),
                        cfg.rtg_beta, 1)
    idx = traj.valid.reshape(-1).nonzero()[:n_rows, 0]
    if idx.shape[0] < n_rows:
        raise AssertionError(f"{idx.shape[0]} valid rows, the check needs {n_rows}")

    def rows(x):
        return x.reshape((-1,) + x.shape[2:])[idx].cpu()

    gen = torch.Generator().manual_seed(7)
    plan = AUG.plan(gen, n_slots, torch.tensor(n_slots), torch.ones(n_rows, dtype=torch.bool))
    ds = U.Dataset(board_before=rows(traj.board_before),
                   action=rows(traj.target_action).long(),
                   action_mask=rows(traj.action_mask), advantage=rows(adv["advantage"]),
                   G_norm=rows(adv["G_norm"]), logprobs=rows(traj.logprobs),
                   target_probs=rows(traj.target_probs),
                   valid=torch.cat([torch.ones(n_rows, dtype=torch.bool), plan.valid]),
                   aug_src=plan.src, aug_tf=plan.transform)
    perm = torch.rand(1, ds.valid.shape[0], generator=gen)
    check_cfg = dataclasses.replace(cfg, dropout=0.0)

    def run(dev):
        _, model, labels = loop.build_model(check_cfg)
        model.load_state_dict(state_dict)
        model.to(dev).eval()
        anchor = None
        if cfg.anchor_kl > 0:
            anchor = (copy.deepcopy(model).requires_grad_(False), cfg.anchor_kl)
        st = opt.OptState(*({k: v.to(dev, copy=True) for k, v in part.items()} for part in
                            (opt_state.momentum, opt_state.m, opt_state.v)), opt_state.step)
        fn = U.make_optimize_fn(model, labels, opt.OptimizerConfig(
            learning_rate=cfg.learning_rate, critic_lr=cfg.critic_lr), cfg.batch_size, 1,
            kl_diagnostic=False, objective=loop.objective(cfg), anchor=anchor)
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
    moved = max(float((cpu_p[n] - state_dict[n].cpu()).abs().max()) for n in cpu_p)
    what = loop.objective(cfg) + (f" with anchor KL {cfg.anchor_kl}" if cfg.anchor_kl > 0
                                  else "")
    return (f"{what} learner minibatch of {n_rows + 2 * n_slots} rows card == CPU"
            + (" (dropout off)" if cfg.dropout > 0 else "") + f": loss "
            f"{float(card.loss):.7g} vs {float(cpu.loss):.7g}, grad norm "
            f"{float(card.grad_norm):.7g} vs {float(cpu.grad_norm):.7g} (rtol "
            f"{LEARNER_RTOL}); params max |diff| {err:.3g} (atol {LEARNER_ATOL}; largest "
            f"move of a weight {moved:.3g})")


def clone_to_cpu(x):
    """A CPU copy of a tensor, or of each tensor field of a NamedTuple (the
    recorder's lane buffers are written in place by the next step)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return type(x)(*(clone_to_cpu(v) if isinstance(v, torch.Tensor) else v for v in x))


def recorder_card_vs_cpu(traj, carry_in, rec_before, rec_card) -> str:
    """The chunk's recorder replayed on the CPU from ``rec_before`` (CPU)
    with the card chunk's own records and starting carry: every field
    bit-equal to ``rec_card`` (the card's recorder after the chunk, on the
    CPU)."""
    rec = rec_before
    ep_points, ep_moves = carry_in.ep_points.cpu(), carry_in.ep_moves.cpu()
    for t in range(traj.steps_executed):
        points, done = traj.points[t].cpu(), traj.done_here[t].cpu()
        rec = capture.record_step(
            rec, ep_moves=ep_moves, board_before=traj.board_before[t].cpu(),
            board_after=traj.board_after[t].cpu(), action=traj.action[t].cpu(),
            points=points, entropy=traj.entropy[t].cpu(), done=done,
            ep_points_new=ep_points + points, ep_moves_new=ep_moves + 1)
        ep_points = torch.where(done, 0, ep_points + points)
        ep_moves = torch.where(done, 0, ep_moves + 1)
    for name in capture.EpisodeRecorder._fields:
        if not torch.equal(getattr(rec, name), getattr(rec_card, name)):
            raise AssertionError(f"recorder {name}: card differs from the CPU replay")
    return (f"recorder card == CPU replay over {traj.steps_executed} trips, every field "
            f"bit-equal (best score {int(rec.best_score)}, {int(rec.best_len)} moves)")


def replay_recorded(rec) -> str:
    """The recorder's committed episode replayed move by move through the
    plain engine on the CPU: each move's points and its board after the
    merge, which must equal the recorded next board but for the one spawned
    tile (a 2 or 4 on an empty cell); the boards chain from move to move;
    the last board has no legal move; the points sum to the score. An
    episode longer than the recorder's cap keeps its first cap - 1 moves and
    its last move: the chain breaks before the last slot, and the stored
    points sum to less than the score."""
    n, true_len = int(rec.best_len), int(rec.best_true_len)
    if n == 0:
        raise AssertionError("the recorder holds no episode")
    before, after = rec.best_before[:n].cpu().int(), rec.best_after[:n].cpu().int()
    action, points = rec.best_action[:n].cpu().long(), rec.best_points[:n].cpu()
    truncated = true_len > n
    moves = engine.all_moves(before)
    rows = torch.arange(n)
    if not torch.equal(moves.scores[action, rows], points):
        raise AssertionError("recorded points differ from the engine's merge scores")
    if not moves.legal[action, rows].all():
        raise AssertionError("the recorded episode plays an illegal move")
    merged = moves.boards[action, rows]
    diff = merged != after
    spawned = diff.sum((1, 2))
    ok = (spawned == 1) & ((merged == 0) & ((after == 1) | (after == 2)) | ~diff).all((1, 2))
    if not ok.all():
        raise AssertionError(f"move {int((~ok).nonzero()[0])}: the board after it is not "
                             "the merged board plus one spawned tile")
    chained = n - 2 if truncated else n - 1
    if not torch.equal(after[:chained], before[1:chained + 1]):
        raise AssertionError("the recorded boards do not chain from move to move")
    if engine.all_moves(after[-1:]).legal.any():
        raise AssertionError("the recorded episode does not end on a board without moves")
    total = int(points.sum())
    if total > int(rec.best_score) or (not truncated and total != int(rec.best_score)):
        raise AssertionError(f"recorded points sum to {total}, score {int(rec.best_score)}")
    return (f"recorded episode (score {int(rec.best_score)}, {true_len} moves"
            + (f", {n} stored: truncated, stored points {total}" if truncated else "")
            + ") replays through the plain engine")


def check_printed(text: str, viz_dir: Path) -> str:
    """A breakdown printed, and viz JSON written with the committed file's
    keys."""
    breakdowns = text.count("Reward breakdown:")
    files = sorted(viz_dir.glob("step_*.json"))
    if breakdowns == 0 or "Final state:" not in text:
        raise AssertionError("no episode breakdown was printed")
    if not files:
        raise AssertionError(f"no viz JSON in {viz_dir}")
    for f in files:
        data = json.loads(f.read_text())
        keys = (tuple(data), tuple(data["moves"][0]), tuple(data["moves"][0]["rewards"]))
        if keys != VIZ_KEYS:
            raise AssertionError(f"{f.name}: keys {keys} are not the committed file's")
    return (f"{breakdowns} breakdowns printed; {len(files)} viz JSON files with the "
            "committed file's keys")


def logged_evals(log_dir) -> list:
    """The eval lines of the metric logs in ``log_dir``."""
    return [json.loads(line) for f in Path(log_dir).glob("*.jsonl")
            for line in f.read_text().splitlines() if "eval/avg_score" in line]


def check_finite(label, scalars: dict) -> None:
    bad = [k for k, v in scalars.items() if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"{label}: non-finite {bad}")


def run_quiet(cfg, on_step) -> tuple:
    """``loop.train(cfg, on_step)`` with its standard output kept: (summary,
    the text it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = loop.train(cfg, on_step=on_step)
    return summary, buf.getvalue()


def fetch_merges(rec, new_high: bool, printed: bool) -> int:
    """Merge launches of a step's episode fetches from the recorder: one for
    the potentials of a new high, and one for them and one for the
    heuristics at print cadence, once an episode is recorded."""
    if rec is None or int(rec.best_len) == 0:
        return 0
    return int(new_high) + 2 * int(printed)


def train_phase(by_phase: dict, device="cuda") -> None:
    """A fresh 3-step run of the expG recipe through the CLI's configuration
    and the trainer, capture and viz on; then the learner and the recorder,
    card against CPU."""
    t0 = time.perf_counter()
    before = merge.launches
    with tempfile.TemporaryDirectory() as tmp:
        viz = Path(tmp) / "viz"
        cfg = cli.train_config(TRAIN_RECIPE + [
            "--steps", str(TRAIN_STEPS), "--checkpoint-dir", tmp, "--viz-dir", str(viz),
            "--print-freq", "1", "--device", device])
        key = np.array([0, cfg.seed], np.uint32)
        _, init_model, _ = loop.build_model(cfg, loop.make_generator("cpu", *key, loop.INIT))
        init = {n: p.detach().clone() for n, p in init_model.named_parameters()}
        steps, marks, highest = [], [merge.launches], [0]

        def on_step(info):
            sync(device)
            marks.append(merge.launches)
            sc = info["scalars"]
            rec = dict(step=info["step"], scalars=sc,
                       rollout_s=info["rollout_s"], learner_s=info["learner_s"],
                       launches=marks[-1] - marks[-2],
                       fetch_merges=fetch_merges(info["recorder"],
                                                 sc["batch_max_score"] > highest[0], True),
                       params={n: p.detach().cpu().clone()
                               for n, p in info["model"].named_parameters()})
            highest[0] = max(highest[0], sc["batch_max_score"])
            if info["step"] == 0:
                st = info["opt_state"]
                rec["first"] = (
                    {n: p.detach().cpu().clone() for n, p in info["model"].state_dict().items()},
                    opt.OptState(*({k: v.clone() for k, v in part.items()}
                                   for part in (st.momentum, st.m, st.v)), st.step),
                    info["traj"], info["carry_in"], clone_to_cpu(info["recorder"]))
            steps.append(rec)

        summary, printed = run_quiet(cfg, on_step)
        shown = check_printed(printed, viz)
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
        check_finite(f"step {s['step'] + 1}", sc)
        if sc["env_steps"] != ENV_STEPS_PER_STEP:
            raise AssertionError(f"step {s['step'] + 1}: {sc['env_steps']} env steps")
        rows = sc["samples"] + sc["augmented_samples"]
        if sc["num_batches"] != math.ceil(rows / cfg.batch_size):
            raise AssertionError(f"step {s['step'] + 1}: {sc['num_batches']} minibatches "
                                 f"for {rows} rows")
        if s["launches"] != MERGES_PER_STEP + s["fetch_merges"]:
            raise AssertionError(f"step {s['step'] + 1}: {s['launches']} merge launches, "
                                 f"expected {MERGES_PER_STEP} + {s['fetch_merges']}")
    state_dict, opt_state, traj, carry_in, rec_card = steps[0]["first"]
    n_legal = (~traj.action_mask).sum(-1).to(torch.float32)
    uniform = float(n_legal.log().mean())
    rollout_gap = float((traj.entropy - n_legal.log()).abs().max())
    first_entropy = steps[0]["scalars"]["entropy"]
    if rollout_gap > 1e-5 or abs(first_entropy - uniform) > 0.02:
        raise AssertionError(f"first policy not uniform over legal moves: rollout gap "
                             f"{rollout_gap}, learner entropy {first_entropy} vs {uniform}")
    check = learner_card_vs_cpu(cfg, state_dict, opt_state, traj)
    rec_check = recorder_card_vs_cpu(traj, carry_in, capture.init_recorder(
        cfg.packed_lanes, cfg.scan_cap), rec_card)
    replayed = replay_recorded(summary["recorder"])
    per_step = "; ".join(
        f"step {s['step'] + 1}: rollout {s['rollout_s']:.3f} s, learner {s['learner_s']:.3f} s, "
        f"{ENV_STEPS_PER_STEP / (s['rollout_s'] + s['learner_s']):.0f} env steps/s, "
        f"{s['scalars']['num_batches']:.0f} minibatches, entropy {s['scalars']['entropy']:.4f}, "
        f"avg completed episode {s['scalars']['batch_avg_score']:.1f}, merge launches "
        f"{s['launches']} ({s['fetch_merges']} for episode fetches)"
        for s in steps)
    phase("train", t0, f"expG recipe (capture on, viz), {TRAIN_STEPS} fresh steps on the "
          f"card: step 1 left every parameter bit-identical, steps 2-3 moved them; scalars "
          f"finite; {ENV_STEPS_PER_STEP} env steps and ceil(S/{cfg.batch_size}) minibatches "
          f"a step; first policy uniform over legal moves (learner entropy "
          f"{first_entropy:.5f} vs {uniform:.5f}); {MERGES_PER_STEP} rollout merge launches "
          f"a step ({by_phase['train']} in all); {per_step}; trained in "
          f"{summary['elapsed']:.3f} s; {check}; {rec_check}; {replayed}; {shown}")


def copy_state(src: Path, dst: str, names=("train_state", "env_carry")) -> None:
    for name in names:
        for ext in ("npz", "json"):
            shutil.copy(src / f"{name}.{ext}", dst)


def recorded_best(src: Path) -> dict:
    with np.load(src / "env_carry.npz") as z:
        return {k: z[f"['{k}']"] for k in capture.BEST_FIELDS}


def check_best_kept(jax_best: dict, port_dir: str, rec) -> str:
    """The JAX run's recorded episode, restored into the recorder, is kept by
    the run and by the env_carry it writes (or beaten by a better one)."""
    saved = recorded_best(Path(port_dir))
    theirs = int(jax_best["best_score"])
    for where, best in (("recorder", {k: getattr(rec, k).cpu().numpy()
                                      for k in capture.BEST_FIELDS}),
                        ("saved env_carry", saved)):
        if int(best["best_score"]) < theirs:
            raise AssertionError(f"{where}: best score {int(best['best_score'])} < the JAX "
                                 f"run's {theirs}")
        if int(best["best_score"]) == theirs:
            for k, v in jax_best.items():
                if not np.array_equal(best[k], v):
                    raise AssertionError(f"{where}: {k} differs from the JAX run's")
    kept = int(saved["best_score"]) == theirs
    return (f"the JAX run's recorded episode (score {theirs}) "
            + ("kept by the recorder and the saved env_carry" if kept
               else f"beaten by one of {int(saved['best_score'])}"))


def train_resume_phase(by_phase: dict, device="cuda") -> None:
    """The JAX run's own step-19,999 state resumed on the card for 2 steps of
    the verbatim recipe (its eval at step 20000), capture and viz on."""
    t0 = time.perf_counter()
    before = merge.launches
    jax_best = recorded_best(RESUME_SOURCE)
    with tempfile.TemporaryDirectory() as tmp:
        copy_state(RESUME_SOURCE, tmp)
        with np.load(RESUME_SOURCE / "env_carry.npz") as z:
            carried = torch.as_tensor(z["['boards']"])
        viz = Path(tmp) / "viz"
        cfg = cli.train_config(TRAIN_RECIPE + [
            "--steps", str(RESUME_STEPS), "--resume", "--checkpoint-dir", tmp,
            "--log-dir", tmp, "--viz-dir", str(viz), "--print-freq", "1", "--device", device])
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

        summary, printed = run_quiet(cfg, on_step)
        by_phase["train_resume"] = merge.launches - before
        shown = check_printed(printed, viz)
        kept = check_best_kept(jax_best, tmp, summary["recorder"])
        replayed = replay_recorded(summary["recorder"])
        evals = logged_evals(tmp)
        _, model, _ = loop.build_model(cfg)
        _, _, _, manifest = loop.load_train_state(tmp, model, "cpu")
        final = {n: p.detach() for n, p in model.named_parameters()}
    if [s["step"] for s in steps] != [20000, 20001]:
        raise AssertionError(f"resumed steps {[s['step'] for s in steps]}, expected 20000-20001")
    STEP_SECONDS["train_resume"] = [s["rollout_s"] + s["learner_s"] for s in steps]
    if not torch.equal(steps[0]["first"], carried):
        raise AssertionError("the first chunk did not start from the 512 carried boards")
    if "Resumed packed env carry" not in printed:
        raise AssertionError("the env carry was not restored")
    episodes = sum(s["episodes"] for s in steps)
    episode_avg = sum(s["score_sum"] for s in steps) / max(episodes, 1)
    if episodes == 0 or episode_avg <= RESUME_MIN_EPISODE_AVG:
        raise AssertionError(f"{episodes} completed episodes, avg {episode_avg} <= "
                             f"{RESUME_MIN_EPISODE_AVG}")
    if [e["step"] for e in evals] != [20000]:
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
          f"at step 20000 on its 512 carried boards, {len(steps)} steps of the verbatim "
          f"recipe: {episodes} completed episodes, avg {episode_avg:.1f} (floor "
          f"{RESUME_MIN_EPISODE_AVG}); sampled eval of {cfg.eval_games} games: "
          + ", ".join(f"step {e['step']} avg {e['eval/avg_score']} max "
                      f"{e['eval/max_score']} pct_2048 {e['eval/pct_2048']}" for e in evals)
          + f" (floor {RESUME_MIN_EVAL_AVG}); step-{RESUME_STEPS - 1} train_state read back "
          f"equal; {kept}; {replayed}; {shown}; " + "; ".join(
              f"step {s['step']}: rollout {s['rollout_s']:.3f} s, learner "
              f"{s['learner_s']:.3f} s, sched_mult {s['scalars']['sched_mult']:.3g}"
              for s in steps)
          + f"; {summary['elapsed']:.3f} s in all; merge launches {by_phase['train_resume']}")


_DP_RECORDS = ("points", "mono_before", "mono_after", "empt_before", "empt_after",
               "value_pred", "valid", "done_here", "ep_score")


def dp_steps(recipe: list, group, device, keep_params=False, keep_records=False) -> tuple:
    """The DP_STEPS of the sharded step of ``recipe`` from RESUME_SOURCE on
    ``device`` as a rank of ``group`` (None: the step without a group): a
    record of each step (scalars, moments in and out, the parameters' hash,
    host seconds, merge launches, the group's collectives), and whether the
    lanes started fresh."""
    cfg = cli.train_config(recipe + ["--steps", str(RESUME_STEPS), "--device", str(device)])
    _, model, labels = loop.build_model(cfg)
    model.to(device).eval()
    opt_state, moments, key, manifest = loop.load_train_state(RESUME_SOURCE, model, device)
    carry, _ = loop.load_env_carry(RESUME_SOURCE, cfg.packed_lanes, cfg.scan_cap, device,
                                   loop.QuietLogger(), group)
    fresh = carry is None
    if fresh:
        carry = loop.init_sharded_env_carry(group, key, cfg.packed_lanes, device)
    step = loop.make_sharded_train_step(group, cfg, model, labels, opt.OptimizerConfig(
        learning_rate=cfg.learning_rate, critic_lr=cfg.critic_lr, beta1=cfg.beta1,
        beta2=cfg.beta2, weight_decay=cfg.weight_decay))
    stats = (group or pmesh.DataGroup()).stats
    records = []
    for ts in DP_STEPS:
        sync(device)
        t0, launches, before = time.perf_counter(), merge.launches, dict(stats)
        res = step(opt_state, moments, key, ts, manifest["current_beta"], carry)
        sc = dict(zip(loop.SCALAR_KEYS, res.outputs["scalars"].cpu().tolist()))
        sync(device)
        params = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
        rec = dict(step=ts, scalars=sc, seconds=time.perf_counter() - t0,
                   rollout_s=res.rollout_s, launches=merge.launches - launches,
                   moments_in=[float(m) for m in moments],
                   moments=[float(m) for m in res.moments],
                   sha=hashlib.sha256(b"".join(p.numpy().tobytes() for p in params.values()))
                   .hexdigest(),
                   collectives={k: stats[k] - before[k] for k in stats})
        if keep_params:
            rec["params"] = params
        if keep_records:
            rec["records"] = {k: getattr(res.traj, k).cpu().numpy() for k in _DP_RECORDS}
            rec["boot_value"] = res.traj.boot_value.cpu().numpy()
        records.append(rec)
        moments, carry = res.moments, res.carry
    return records, fresh


def dp_rank(rank: int, url: str, backend: str, size: int, card: str, recipe: list) -> dict:
    """A spawned rank of train_dp (b)/(c): ``card`` "shared" puts every rank
    on cuda:0, "own" rank r on cuda:r, "cpu" on the CPU (a rehearsal)."""
    device = (torch.device("cpu") if card == "cpu"
              else torch.device("cuda", 0 if card == "shared" else rank))
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False  # full f32, as the JAX reference
    else:  # a rehearsal: count the plain merge's calls as the kernel's launches
        torch.set_num_threads(1)
        plain = merge.merge4_plain

        def counted(*args, **kwargs):
            merge.launches += 1
            return plain(*args, **kwargs)

        merge.merge4_plain = counted
    group = pmesh.init_distributed(url, rank=rank, world_size=size, device=device,
                                   backend=backend)
    try:
        merge.launches = 0
        records, fresh = dp_steps(recipe, group, device, keep_records=True)
        return dict(records=records, fresh=fresh, launches=merge.launches)
    finally:
        pmesh.shutdown()


def dp_single_rank(recipe: list, device) -> str:
    """(a): the sharded step at world size 1 over NCCL (Gloo on the CPU)
    against the step without a group, from the same state and generators."""
    with tempfile.TemporaryDirectory() as tmp:
        group = pmesh.init_distributed(f"file://{tmp}/rendezvous", rank=0, world_size=1,
                                       device=device)
        try:
            probe = torch.arange(4.0, device=device)
            torch.distributed.all_reduce(probe, group=group.group)
            if not torch.equal(probe.cpu(), torch.arange(4.0)):
                raise AssertionError(f"{group.backend} all_reduce at world size 1: {probe}")
            ranked, _ = dp_steps(recipe, group, device, keep_params=True)
        finally:
            pmesh.shutdown()
    plain, _ = dp_steps(recipe, None, device, keep_params=True)
    err = 0.0
    for r, p in zip(ranked, plain):
        for k in EXACT_SCALARS:
            if r["scalars"][k] != p["scalars"][k]:
                raise AssertionError(f"step {r['step']}: {k} {r['scalars'][k]} vs "
                                     f"{p['scalars'][k]} without a group")
        for g, w in zip(r["moments"], p["moments"]):
            if abs(g - w) > DP_SINGLE_RTOL * abs(w):
                raise AssertionError(f"step {r['step']}: moments {r['moments']} vs {p['moments']}")
        for n, w in p["params"].items():
            err = max(err, float((r["params"][n] - w).abs().max()))
        if err > DP_SINGLE_ATOL:
            raise AssertionError(f"step {r['step']}: parameters differ by {err}")
    resumed = STEP_SECONDS.get("train_resume", [])
    return (f"(a) {group.backend} at world size 1 (all_reduce probe exact): "
            f"{len(DP_STEPS)} steps == the step without a group (counts exact, moments "
            f"rtol {DP_SINGLE_RTOL}, params max |diff| {err:.3g} <= {DP_SINGLE_ATOL}); host s "
            "a step: " + ", ".join(f"{r['seconds']:.3f}" for r in ranked)
            + " vs " + ", ".join(f"{p['seconds']:.3f}" for p in plain) + " without a group, "
            + (", ".join(f"{x:.3f}" for x in resumed) or "not run") + " in train_resume; "
            + "collectives a step: " + ", ".join(
                f"{r['collectives']['calls']} ({r['collectives']['bytes']} B)" for r in ranked)
            + f"; merge launches {sum(r['launches'] for r in ranked + plain)}")


def dp_ranks(recipe: list, backend: str, card: str) -> tuple:
    """(b)/(c): DP_RANKS spawned ranks; (text, their merge launches)."""
    cfg = cli.train_config(recipe + ["--device", "cpu"])
    with tempfile.TemporaryDirectory() as tmp:
        ranks = pmesh.spawn(dp_rank, DP_RANKS, (f"file://{tmp}/rendezvous", backend,
                                                DP_RANKS, card, recipe),
                            timeout_s=DP_RANK_TIMEOUT_S)
    if not all(r["fresh"] for r in ranks):
        raise AssertionError("the lanes of a sharded_d 1 env_carry were restored at D=2")
    per_rank = 2 * cfg.horizon * len(DP_STEPS)
    if [r["launches"] for r in ranks] != [per_rank] * DP_RANKS:
        raise AssertionError(f"merge launches by rank {[r['launches'] for r in ranks]}, "
                             f"expected {per_rank} each")
    done_scores, lines = [], []
    for i, ts in enumerate(DP_STEPS):
        recs = [r["records"][i] for r in ranks]
        if len({r["sha"] for r in recs}) != 1 or any(r["scalars"] != recs[0]["scalars"]
                                                     for r in recs):
            raise AssertionError(f"step {ts}: the ranks' parameters or scalars differ")
        sc = recs[0]["scalars"]
        if sc["env_steps"] != cfg.packed_lanes * cfg.horizon:
            raise AssertionError(f"step {ts}: {sc['env_steps']} env steps")
        check_finite(f"train_dp step {ts}", sc)
        joined = {k: torch.as_tensor(np.concatenate([r["records"][k] for r in recs], axis=1))
                  for k in _DP_RECORDS}
        boot = torch.as_tensor(np.concatenate([r["boot_value"] for r in recs]))
        host = A.compute_packed(*(joined[k] for k in _DP_RECORDS[:7]), joined["done_here"],
                                boot, cfg.reward_weights, cfg.gamma,
                                A.RtgMoments(*map(torch.tensor, recs[0]["moments_in"])),
                                cfg.rtg_beta, ts + 1)
        for g, w in zip(recs[0]["moments"], host["new_moments"]):
            if abs(g - float(w)) > DP_HOST_RTOL * abs(float(w)):
                raise AssertionError(f"step {ts}: moments {recs[0]['moments']} vs the host's "
                                     f"{[float(x) for x in host['new_moments']]}")
        done_scores += joined["ep_score"][joined["done_here"]].tolist()
        seconds = max(r["seconds"] for r in recs)
        c = recs[0]["collectives"]
        lines.append(f"step {ts}: {seconds:.3f} host s ({sc['env_steps'] / seconds:.0f} env "
                     f"steps/s), {sc['num_batches']:.0f} minibatches, {c['calls']} "
                     f"collectives ({c['bytes']} B a rank, "
                     f"{max(r['collectives']['seconds'] for r in recs) * 1e3:.1f} host ms)")
    avg = sum(done_scores) / max(len(done_scores), 1)
    if not done_scores or avg <= DP_MIN_EPISODE_AVG:
        raise AssertionError(f"{len(done_scores)} completed episodes, avg {avg} <= "
                             f"{DP_MIN_EPISODE_AVG}")
    launches = sum(r["launches"] for r in ranks)
    return (f"{DP_RANKS} ranks over {backend}, {card} card(s), {cfg.packed_lanes // DP_RANKS} "
            f"lanes and a {cfg.batch_size // DP_RANKS} batch each, fresh lanes: parameters "
            f"bit-identical, {cfg.packed_lanes * cfg.horizon} env steps and moments == the "
            f"host's over both ranks' records (rtol {DP_HOST_RTOL}) each step; "
            f"{len(done_scores)} completed episodes, avg {avg:.1f} (floor {DP_MIN_EPISODE_AVG}); "
            + "; ".join(lines) + f"; merge launches {per_rank} a rank", launches)


def train_dp_phase(by_phase: dict, device="cuda", recipe=None) -> None:
    """The data-parallel step: (a) one NCCL rank against the step without a
    group, (b) two Gloo ranks sharing the card, (c) two NCCL ranks on two
    cards when there are two."""
    t0 = time.perf_counter()
    recipe = TRAIN_RECIPE if recipe is None else recipe
    before = merge.launches
    single = dp_single_rank(recipe, torch.device(device))
    by_phase["train_dp"] = merge.launches - before
    card = "shared" if torch.device(device).type == "cuda" else "cpu"
    shared, launches = dp_ranks(recipe, "gloo", card)
    texts = [single, "(b) " + shared]
    if torch.device(device).type == "cuda" and torch.cuda.device_count() >= DP_RANKS:
        own, more = dp_ranks(recipe, "nccl", "own")
        texts.append("(c) " + own)
        launches += more
    else:
        texts.append(f"(c) skipped: {DP_RANKS} NCCL ranks need {DP_RANKS} cards, this machine "
                     f"has {torch.cuda.device_count()}")
    REMOTE_LAUNCHES["train_dp"] = launches
    by_phase["train_dp"] += launches
    phase("train_dp", t0, "; ".join(texts) + f"; merge launches {by_phase['train_dp']}")


def train_urm_phase(by_phase: dict, device="cuda") -> None:
    """The JAX run's URM (checkpoints_urm_r5, step 449, 4,096 lanes)
    resumed on the card for 2 steps of scripts/train_urm_long.sh, with one
    eval of 32 sampled games; a URM learner minibatch card against CPU."""
    t0 = time.perf_counter()
    before = merge.launches
    jax_best = recorded_best(URM_SOURCE)
    with tempfile.TemporaryDirectory() as tmp:
        copy_state(URM_SOURCE, tmp)
        with np.load(URM_SOURCE / "env_carry.npz") as z:
            carried = torch.as_tensor(z["['boards']"])
        viz = Path(tmp) / "viz"
        cfg = cli.train_config(URM_RECIPE + URM_EVAL + [
            "--steps", str(URM_STEPS), "--resume", "--checkpoint-dir", tmp, "--log-dir", tmp,
            "--viz-dir", str(viz), "--print-freq", "1", "--device", device])
        steps, read_back = [], []

        def on_step(info):
            traj = info["traj"]
            done = traj.done_here
            rec = dict(step=info["step"], first=traj.board_before[0].cpu(),
                       score_sum=float(traj.ep_score[done].to(torch.float64).sum()),
                       episodes=int(done.sum()), rollout_s=info["rollout_s"],
                       learner_s=info["learner_s"], scalars=info["scalars"])
            if info["step"] == URM_STEPS - 2:
                # The step's train_state checkpoint (--checkpoint-freq 10),
                # read back against the live model.
                _, model, _ = loop.build_model(cfg)
                _, _, _, manifest = loop.load_train_state(tmp, model, "cpu")
                read_back.append((manifest["train_step"], all(
                    torch.equal(p.detach(), q.detach().cpu()) for p, q in
                    zip(model.parameters(), info["model"].parameters()))))
                st = info["opt_state"]
                rec["learner"] = (
                    {n: p.detach().cpu().clone() for n, p in info["model"].state_dict().items()},
                    opt.OptState(*({k: v.clone() for k, v in part.items()}
                                   for part in (st.momentum, st.m, st.v)), st.step), traj)
            steps.append(rec)

        summary, printed = run_quiet(cfg, on_step)
        by_phase["train_urm"] = merge.launches - before
        shown = check_printed(printed, viz)
        kept = check_best_kept(jax_best, tmp, summary["recorder"])
        replayed = replay_recorded(summary["recorder"])
        evals = logged_evals(tmp)
    if [s["step"] for s in steps] != [URM_STEPS - 2, URM_STEPS - 1]:
        raise AssertionError(f"resumed steps {[s['step'] for s in steps]}")
    if not torch.equal(steps[0]["first"], carried):
        raise AssertionError("the first chunk did not start from the 4096 carried boards")
    if read_back != [(URM_STEPS - 2, True)]:
        raise AssertionError(f"step-{URM_STEPS - 2} train_state read back: {read_back}")
    episodes = sum(s["episodes"] for s in steps)
    episode_avg = sum(s["score_sum"] for s in steps) / max(episodes, 1)
    if episodes == 0 or episode_avg <= URM_MIN_EPISODE_AVG:
        raise AssertionError(f"{episodes} completed episodes, avg {episode_avg} <= "
                             f"{URM_MIN_EPISODE_AVG}")
    if [e["step"] for e in evals] != [URM_STEPS - 2]:
        raise AssertionError(f"evals at steps {[e['step'] for e in evals]}")
    if evals[0]["eval/avg_score"] <= URM_MIN_EVAL_AVG:
        raise AssertionError(f"URM eval avg {evals[0]['eval/avg_score']} <= {URM_MIN_EVAL_AVG}")
    for s in steps:
        check_finite(f"step {s['step']}", s["scalars"])
    state_dict, opt_state, traj = steps[0]["learner"]
    check = learner_card_vs_cpu(cfg, state_dict, opt_state, traj, URM_LEARNER_ROWS,
                                URM_LEARNER_SLOTS)
    e = evals[0]
    phase("train_urm", t0, f"{URM_SOURCE.name} (JAX-written URM H=64x2, 4 loops, step 449) "
          f"resumed on its 4096 carried boards, 2 steps of scripts/train_urm_long.sh "
          f"(eval changed to {' '.join(URM_EVAL)}): {episodes} completed episodes, avg "
          f"{episode_avg:.1f} (floor {URM_MIN_EPISODE_AVG}); sampled eval at step "
          f"{e['step']}: avg {e['eval/avg_score']}, max {e['eval/max_score']}, pct_2048 "
          f"{e['eval/pct_2048']} (floor {URM_MIN_EVAL_AVG}); step-{URM_STEPS - 2} train_state "
          f"read back equal; {kept}; {replayed}; {shown}; " + "; ".join(
              f"step {s['step']}: rollout {s['rollout_s']:.3f} s, learner "
              f"{s['learner_s']:.3f} s, {s['scalars']['num_batches']:.0f} minibatches, "
              f"entropy {s['scalars']['entropy']:.4f}" for s in steps)
          + f"; {summary['elapsed']:.3f} s in all; {check}; merge launches "
          f"{by_phase['train_urm']}")


def train_exact_phase(by_phase: dict, device="cuda") -> None:
    """The JAX run's exact-episodes MLP (checkpoints_expA, step 19,999)
    resumed on the card for 2 steps of scripts/train_expA2.sh."""
    t0 = time.perf_counter()
    before = merge.launches
    with tempfile.TemporaryDirectory() as tmp:
        copy_state(EXACT_SOURCE, tmp, names=("train_state",))
        viz = Path(tmp) / "viz"
        cfg = cli.train_config(EXACT_RECIPE + [
            "--steps", str(EXACT_STEPS), "--resume", "--checkpoint-dir", tmp, "--log-dir", tmp,
            "--viz-dir", str(viz), "--print-freq", "1", "--device", device])
        steps, marks = [], [merge.launches]

        def on_step(info):
            sync(device)
            marks.append(merge.launches)
            traj = info["traj"]
            steps.append(dict(step=info["step"], trips=traj.steps_executed,
                              moves=int(traj.num_moves.sum()),
                              ended=int(traj.ended.sum()), scalars=info["scalars"],
                              launches=marks[-1] - marks[-2], rollout_s=info["rollout_s"],
                              learner_s=info["learner_s"]))

        summary, printed = run_quiet(cfg, on_step)
        by_phase["train_exact"] = merge.launches - before
        shown = check_printed(printed, viz)
        evals = logged_evals(tmp)
        _, model, _ = loop.build_model(cfg)
        _, _, _, manifest = loop.load_train_state(tmp, model, "cpu")
    if [s["step"] for s in steps] != [20000, 20001]:
        raise AssertionError(f"resumed steps {[s['step'] for s in steps]}, expected 20000-20001")
    for s in steps:
        sc = s["scalars"]
        check_finite(f"step {s['step']}", sc)
        if sc["env_steps"] != s["moves"]:
            raise AssertionError(f"step {s['step']}: env_steps {sc['env_steps']} != "
                                 f"{s['moves']} moves")
        # One merge a trip and one for the fresh boards, one for the
        # heuristics of the printed episode, and the eval's.
        if s["launches"] < s["trips"] + 2 or (s["step"] % cfg.eval_freq
                                              and s["launches"] != s["trips"] + 2):
            raise AssertionError(f"step {s['step']}: {s['launches']} merge launches for "
                                 f"{s['trips']} trips")
        if sc["batch_avg_score"] <= EXACT_MIN_BATCH_AVG:
            raise AssertionError(f"step {s['step']}: batch average {sc['batch_avg_score']} "
                                 f"<= {EXACT_MIN_BATCH_AVG}")
    if [e["step"] for e in evals] != [20000]:
        raise AssertionError(f"evals at steps {[e['step'] for e in evals]}")
    if evals[0]["eval/avg_score"] <= EXACT_MIN_EVAL_AVG:
        raise AssertionError(f"eval avg {evals[0]['eval/avg_score']} <= {EXACT_MIN_EVAL_AVG}")
    if manifest["train_step"] != EXACT_STEPS - 1:
        raise AssertionError(f"saved train_state is at step {manifest['train_step']}")
    e = evals[0]
    phase("train_exact", t0, f"{EXACT_SOURCE.name} (JAX-written MLP H=196x2, step 19,999) "
          f"resumed, 2 steps of scripts/train_expA2.sh (exact episodes, "
          f"{cfg.num_episodes} games, cap {cfg.rollout_cap}): " + "; ".join(
              f"step {s['step']}: {s['trips']} trips, {s['moves']} moves (== env_steps), "
              f"{s['ended']} games ended, batch avg {s['scalars']['batch_avg_score']:.1f} "
              f"max {s['scalars']['batch_max_score']:.0f}, rollout {s['rollout_s']:.3f} s, "
              f"learner {s['learner_s']:.3f} s, {s['scalars']['num_batches']:.0f} "
              f"minibatches, merge launches {s['launches']}" for s in steps)
          + f" (floor {EXACT_MIN_BATCH_AVG}); sampled eval of {cfg.eval_games} games at step "
          f"{e['step']}: avg {e['eval/avg_score']}, max {e['eval/max_score']}, pct_2048 "
          f"{e['eval/pct_2048']} (floor {EXACT_MIN_EVAL_AVG}); step-{EXACT_STEPS - 1} "
          f"train_state saved; {shown}; {summary['elapsed']:.3f} s in all; merge launches "
          f"{by_phase['train_exact']}")


def search_merges(depth: int, pruned: bool = False) -> int:
    """Merge launches of one ``expectimax_scores`` call handed the root's
    moves (one handed none adds its own ``all_moves``): the leaves'
    ``all_moves`` at depth 1; deeper, each of the 32 spawn slots runs
    ``state_values``: its own ``all_moves``, under pruning from depth 3 the
    leaves of a 1-ply search, and its subtree."""
    if depth <= 1:
        return 1
    return NUM_SPAWNS * (1 + (pruned and depth >= 3) + search_merges(depth - 1, pruned))


def check_expert_traj(traj, n_expert: int) -> tuple:
    """The expert-driven envs took their ``target_action``, every taken
    action is legal, and every ``target_probs`` row of a board with a legal
    move sums to 1 over the legal moves (0 on the illegal ones). Returns
    (rows checked, largest |sum - 1|, agreement of the policy envs' moves
    with the expert's labels)."""
    valid = traj.valid
    action, target = traj.action.long(), traj.target_action.long()
    if not (action == target)[:, :n_expert][valid[:, :n_expert]].all():
        raise AssertionError("an expert-driven env did not take its target_action")
    taken_illegal = traj.action_mask.gather(-1, action[..., None])[..., 0]
    if (taken_illegal & valid).any():
        raise AssertionError("an illegal action was taken")
    probs, illegal = traj.target_probs[valid], traj.action_mask[valid]
    live = ~illegal.all(-1)
    if (probs[illegal] != 0).any():
        raise AssertionError("target_probs > 0 on an illegal move")
    sum_err = float((probs[live].sum(-1) - 1).abs().max())
    if sum_err > 1e-5:
        raise AssertionError(f"target_probs rows sum to 1 within {sum_err}")
    policy = valid[:, n_expert:]
    agree = float((action == target)[:, n_expert:][policy].float().mean())
    return int(valid.sum()), sum_err, agree


def search_card_vs_cpu(cfg, boards: torch.Tensor, labels: torch.Tensor) -> str:
    """The teacher's depth-``cfg.expert_depth`` scores of ``boards`` (trips,
    N, 4, 4) on the card, a trip at a time as the rollout ran them, against
    a CPU copy (the same checkpoint and bf16 leaves, the plain merge) to
    SEARCH_TOL; and the rollout's ``labels`` (trips, N) of them against the
    CPU's first argmax, except where the CPU's top two scores lie within
    that tolerance (near-ties, counted)."""
    scores = {}
    with torch.inference_mode():
        for dev in (boards.device, torch.device("cpu")):
            teacher, coefs = loop.load_teacher(cfg, dev)
            scores[dev.type] = np.concatenate([
                expectimax_scores(teacher, b.to(dev), None, coefs, cfg.expert_depth).cpu().numpy()
                for b in boards])
    card, cpu = scores[boards.device.type], scores["cpu"]
    if not np.array_equal(np.isfinite(card), np.isfinite(cpu)):
        raise AssertionError("search scores finite in other places on the card and the CPU")
    ok = np.isfinite(cpu)
    err = assert_close("expert search, card vs CPU", card[ok], cpu[ok], SEARCH_TOL)
    top2 = np.sort(np.where(ok, cpu, -np.inf), 1)[:, -2:]
    near = np.abs(top2[:, 1] - top2[:, 0]) <= SEARCH_TOL * (np.abs(top2[:, 1]) + 1)
    labels = labels.reshape(-1).long().cpu().numpy()
    if not np.array_equal(labels[~near], cpu.argmax(1)[~near]):
        raise AssertionError("target_action differs from the CPU's argmax away from near-ties")
    return (f"depth-{cfg.expert_depth} teacher scores of the first {boards.shape[0]} trips' "
            f"{labels.size} boards card == CPU to {SEARCH_TOL} (max |diff| {err:.6g}); "
            f"target_action == the CPU argmax on {int((~near).sum())} boards, "
            f"{int(near.sum())} near-ties (top two within {SEARCH_TOL}) not held")


def expert_phase_run(name: str, recipe: list, source: Path, stop: int, by_phase: dict,
                     device: str) -> dict:
    """Resume ``source``'s train_state with ``recipe`` capped at
    EXPERT_MAX_STEPS trips until step ``stop``; per step its merge launches
    (trips x (the search's + the step's) + 1 for the fresh boards, + 1 at
    print cadence, + an eval-in-train's at eval cadence, which the cap also
    cuts) and the checks of :func:`check_expert_traj`; the first step's
    state and trajectory for the learner check; then the recipe's eval of
    its games at the last step, uncapped (to the recipe's scan cap), as
    eval-in-train runs it in the recipe."""
    t0 = time.perf_counter()
    before = merge.launches
    with tempfile.TemporaryDirectory() as tmp:
        copy_state(source, tmp, names=("train_state",))
        cfg = cli.train_config(recipe + [
            "--steps", str(stop), "--resume", "--checkpoint-dir", tmp, "--log-dir", tmp,
            "--max-steps", str(EXPERT_MAX_STEPS), "--device", device])
        n_expert = int(round(cfg.expert_mix * cfg.num_episodes))
        per_trip = search_merges(cfg.expert_depth) + 1
        steps, marks = [], [merge.launches]

        def on_step(info):
            sync(device)
            marks.append(merge.launches)
            traj = info["traj"]
            rows, sum_err, agree = check_expert_traj(traj, n_expert)
            rec = dict(step=info["step"], trips=traj.steps_executed,
                       moves=int(traj.num_moves.sum()), scalars=info["scalars"],
                       launches=marks[-1] - marks[-2], rollout_s=info["rollout_s"],
                       learner_s=info["learner_s"], rows=rows, sum_err=sum_err,
                       agree=agree)
            if not steps:
                st = info["opt_state"]
                rec["first"] = (
                    {n: p.detach().cpu().clone() for n, p in info["model"].state_dict().items()},
                    opt.OptState(*({k: v.clone() for k, v in part.items()}
                                   for part in (st.momentum, st.m, st.v)), st.step), traj)
            steps.append(rec)

        summary, printed = run_quiet(cfg, on_step)
        t_eval = time.perf_counter()
        key = np.load(source / "train_state.npz")["['key']"]
        eval_cfg = dataclasses.replace(cfg, max_steps=None)
        em = loop.make_eval_fn(eval_cfg)(summary["model"], key, stop - 1,
                                         (stop - 1) // cfg.eval_freq)
        sync(device)
        eval_s = time.perf_counter() - t_eval
        _, model, _ = loop.build_model(cfg)
        _, _, _, manifest = loop.load_train_state(tmp, model, "cpu")
    if [s["step"] for s in steps] != list(range(stop - len(steps), stop)) or not steps:
        raise AssertionError(f"resumed steps {[s['step'] for s in steps]}, expected up to "
                             f"{stop - 1}")
    if manifest["train_step"] != stop - 1:
        raise AssertionError(f"saved train_state is at step {manifest['train_step']}")
    for s in steps:
        check_finite(f"{name} step {s['step']}", s["scalars"])
        if s["scalars"]["env_steps"] != s["moves"]:
            raise AssertionError(f"step {s['step']}: env_steps {s['scalars']['env_steps']} "
                                 f"!= {s['moves']} moves")
        # The trips' searches and steps, the fresh boards' merge, one for
        # the heuristics of a printed episode, and an eval-in-train's (its
        # fresh boards and at most rollout_cap trips).
        expected = s["trips"] * per_trip + 1 + int(s["step"] % cfg.print_frequency == 0)
        extra = s["launches"] - expected
        if not (2 <= extra <= 1 + cfg.rollout_cap if s["step"] % cfg.eval_freq == 0
                else extra == 0):
            raise AssertionError(f"step {s['step']}: {s['launches']} merge launches for "
                                 f"{s['trips']} trips, expected {s['trips']} x {per_trip} "
                                 f"+ {expected - s['trips'] * per_trip}, and an eval's")
    by_phase[name] = merge.launches - before
    return dict(t0=t0, cfg=cfg, steps=steps, em=em, eval_s=eval_s, printed=printed,
                per_trip=per_trip, n_expert=n_expert,
                eval_launches=merge.launches - marks[-1])


def expert_steps_text(run: dict) -> str:
    return "; ".join(
        f"step {s['step']}: {s['trips']} trips ({s['launches']} merge launches, "
        f"{s['rollout_s'] * 1e3 / s['trips']:.3f} ms a trip), {s['moves']} moves, rollout "
        f"{s['rollout_s']:.3f} s, learner {s['learner_s']:.3f} s, "
        f"{s['scalars']['num_batches']:.0f} minibatches, loss {s['scalars']['loss']:.6g}, "
        f"target_probs of {s['rows']} rows sum to 1 within {s['sum_err']:.3g}, policy envs "
        f"agree with the expert on {s['agree']:.3f} of their moves" for s in run["steps"])


def train_expert_phase(by_phase: dict, device="cuda") -> None:
    """checkpoints_expF (the JAX run's expert-iteration student, step 200)
    resumed on the card for 2 steps of scripts/train_expF_wide.sh, its
    rollout capped at EXPERT_MAX_STEPS trips: the frozen expA teacher's
    calibration, its scores on the card against the CPU, the labels, the
    expert-driven envs' moves, an imitation-sharp learner minibatch card
    against CPU, the merge launches, and the recipe's eval."""
    run = expert_phase_run("train_expert", EXPERT_RECIPE, EXPERT_SOURCE, EXPERT_STEPS,
                           by_phase, device)
    cfg, first = run["cfg"], run["steps"][0]
    coefs = load_search_coefs(cfg.expert_src)
    if f"(sigma={coefs.sigma:.1f}, mu={coefs.mu:.1f})" not in run["printed"]:
        raise AssertionError("the frozen teacher's calibration was not printed")
    state_dict, opt_state, traj = first["first"]
    before = merge.launches
    scores = search_card_vs_cpu(cfg, traj.board_before[:EXPERT_CHECK_TRIPS].to(torch.int32),
                                traj.target_action[:EXPERT_CHECK_TRIPS])
    learner = learner_card_vs_cpu(cfg, state_dict, opt_state, traj)
    by_phase["train_expert"] += merge.launches - before
    em = run["em"]
    if em["avg_score"] <= EXPERT_MIN_EVAL_AVG:
        raise AssertionError(f"eval avg {em['avg_score']} <= {EXPERT_MIN_EVAL_AVG}")
    phase("train_expert", run["t0"], f"{EXPERT_SOURCE.name} (JAX-written student MLP "
          f"H=384x3, step 200) resumed, 2 steps of scripts/train_expF_wide.sh with "
          f"--max-steps {EXPERT_MAX_STEPS} (the recipe's directories and --steps changed): "
          f"frozen {Path(cfg.expert_src).name} teacher, depth {cfg.expert_depth}, bf16 "
          f"leaves, load_search_coefs sigma={coefs.sigma:.6g} mu={coefs.mu:.6g} "
          f"points={coefs.points} mono={coefs.mono} gamma={coefs.gamma}; {scores}; "
          f"the {run['n_expert']} expert-driven envs took their labels, every move legal; "
          + expert_steps_text(run) + f"; {learner}; eval of {cfg.eval_games} sampled games "
          f"at step {EXPERT_STEPS - 1} (uncapped, as eval-in-train runs it): avg "
          f"{em['avg_score']}, max {em['max_score']}, median {em['median_score']}, pct_2048 "
          f"{em['pct_2048']} (floor {EXPERT_MIN_EVAL_AVG}), {run['eval_s']:.3f} s; "
          f"step-{EXPERT_STEPS - 1} train_state saved; merge launches "
          f"{by_phase['train_expert']} ({run['per_trip']} a trip + 1 a step, eval "
          f"{run['eval_launches']}, checks {merge.launches - before})")


def train_expert_live_phase(by_phase: dict, device="cuda") -> None:
    """checkpoints_expA's train_state resumed on the card for 1 step of
    scripts/train_expC_ei.sh (the live teacher) with --anchor-kl 0.5: the
    live coefs against the CPU's from the saved moments, a learner
    minibatch with the anchor card against CPU, and the recipe's eval."""
    arrays = np.load(EXACT_SOURCE / "train_state.npz")
    run = expert_phase_run("train_expert_live", EXPERT_LIVE_RECIPE, EXACT_SOURCE,
                           EXPERT_LIVE_STEPS, by_phase, device)
    cfg, first = run["cfg"], run["steps"][0]
    coefs = {}
    for dev in (device, "cpu"):
        moments = A.RtgMoments(*(torch.tensor(arrays[f"['moments'].{f}"], device=dev)
                                 for f in A.RtgMoments._fields))
        c = loop.expert_args(cfg, None, None, moments, EXPERT_LIVE_STEPS)["expert_coefs"]
        if not isinstance(c.sigma, torch.Tensor) or c.sigma.device.type != torch.device(
                dev).type:
            raise AssertionError(f"live coefs not on {dev}")
        coefs[dev] = (float(c.sigma), float(c.mu))
    if not np.allclose(coefs[device], coefs["cpu"], rtol=1e-6, atol=0):
        raise AssertionError(f"live coefs card {coefs[device]} vs CPU {coefs['cpu']}")
    if "Anchor KL trust region: strength 0.5" not in run["printed"]:
        raise AssertionError("the anchor was not set up")
    state_dict, opt_state, traj = first["first"]
    before = merge.launches
    learner = learner_card_vs_cpu(cfg, state_dict, opt_state, traj)
    by_phase["train_expert_live"] += merge.launches - before
    em = run["em"]
    if em["avg_score"] <= EXPERT_LIVE_MIN_EVAL_AVG:
        raise AssertionError(f"eval avg {em['avg_score']} <= {EXPERT_LIVE_MIN_EVAL_AVG}")
    phase("train_expert_live", run["t0"], f"{EXACT_SOURCE.name} (JAX-written MLP H=196x2, "
          f"step 19,999) resumed, 1 step of scripts/train_expC_ei.sh without "
          f"--decouple-critic, with --anchor-kl 0.5 and --max-steps {EXPERT_MAX_STEPS}: live "
          f"depth-{cfg.expert_depth} teacher, coefs from the moments card (sigma, mu) "
          f"{coefs[device]} == CPU {coefs['cpu']} (rtol 1e-6); the {run['n_expert']} "
          f"expert-driven envs took their labels, every move legal; " + expert_steps_text(run)
          + f"; {learner}; the loop's own eval at step {EXPERT_LIVE_STEPS - 1} ran to "
          f"--max-steps; eval of {cfg.eval_games} sampled games at step "
          f"{EXPERT_LIVE_STEPS - 1} (uncapped): avg {em['avg_score']}, max "
          f"{em['max_score']}, pct_2048 {em['pct_2048']} (floor {EXPERT_LIVE_MIN_EVAL_AVG}), "
          f"{run['eval_s']:.3f} s; merge launches {by_phase['train_expert_live']} "
          f"({run['per_trip']} a trip + 1 a step, eval {run['eval_launches']})")


def exponents(values) -> np.ndarray:
    v = np.asarray(values, np.int64)
    return np.where(v > 0, np.log2(np.maximum(v, 1)), 0).astype(np.int32)


def replay_demo_game(path: Path) -> dict:
    """A demo ``best_game.json`` through the plain engine (CPU): each move's
    state_before merges in its direction to a board one spawn (an empty
    cell turned to a 2 or a 4) short of its state_after, scoring its
    points; each state_before is the last state_after; the points add up to
    the score. Returns the game."""
    game = json.loads(path.read_text())
    moves = game["moves"]
    if not moves:
        raise AssertionError(f"{path}: no moves")
    before = np.stack([exponents(m["state_before"]) for m in moves])
    after = np.stack([exponents(m["state_after"]) for m in moves])
    action = np.array([DIRECTION_NAMES.index(m["action"]) for m in moves])
    if not np.array_equal(before[1:], after[:-1]):
        raise AssertionError(f"{path}: a move does not start where the last one ended")
    ms = engine.all_moves(torch.as_tensor(before))
    idx = np.arange(len(moves))
    moved = ms.boards.numpy()[action, idx]
    if not ms.legal.numpy()[action, idx].all():
        raise AssertionError(f"{path}: an illegal move")
    if not np.array_equal(ms.scores.numpy()[action, idx], [m["points_earned"] for m in moves]):
        raise AssertionError(f"{path}: points differ from the plain merge's")
    diff = (moved != after).reshape(len(moves), 16)
    spawned = after.reshape(len(moves), 16)[diff]
    if not ((diff.sum(1) == 1).all() and (moved.reshape(len(moves), 16)[diff] == 0).all()
            and np.isin(spawned, (1, 2)).all()):
        raise AssertionError(f"{path}: a state_after is not its merged board plus one spawn")
    if sum(m["points_earned"] for m in moves) != game["score"]:
        raise AssertionError(f"{path}: points add up to "
                             f"{sum(m['points_earned'] for m in moves)}, score {game['score']}")
    return game


def export_matches_cpu(src: Path, out: Path, cpu_dir: Path) -> None:
    """The card's exported assets byte-equal to an export of ``src`` loaded
    on the CPU (model_config.json with the same search coefs)."""
    model, mcfg, mtype = load_model_checkpoint(str(src), device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        export_demo_assets(model, mcfg, mtype, None, cpu_dir,
                           search_coefs=load_search_coefs(str(src)))
    for name in DEMO_ASSETS:
        if (out / name).read_bytes() != (cpu_dir / name).read_bytes():
            raise AssertionError(f"{src.name}: {name} differs from the CPU's export")


def export_demo_phase(by_phase: dict, device="cuda") -> None:
    """export-demo through the CLI: (a) sampled best of 16 on expG, (b)
    depth-1 search play of 8 games on expA, (c) the URM with (a)'s game;
    each export == the CPU's, each best game replayed through the plain
    engine, the floors on the best games."""
    t0 = time.perf_counter()
    before = merge.launches
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        game_a = tmp / "a" / "best_game.json"
        for tag, src, flags in (
                ("a", DEMO_SAMPLED, ["-n", str(DEMO_SAMPLED_GAMES)]),
                ("b", DEMO_SEARCH, ["--search", "--search-depth", "1",
                                    "-n", str(DEMO_SEARCH_GAMES)]),
                ("c", DEMO_URM, ["--game", str(game_a)])):
            t1, start = time.perf_counter(), merge.launches
            ckpt = tmp / f"{tag}_{src.name}"
            shutil.copytree(src, ckpt)
            out = tmp / tag
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(["export-demo", "--model", str(ckpt), "--output", str(out),
                          *flags, "--device", device])
            sync(device)
            seconds, launches = time.perf_counter() - t1, merge.launches - start
            names = {p.name for p in out.iterdir()}
            if names != {"best_game.json", "best_model.npz", "best_model.json", *DEMO_ASSETS}:
                raise AssertionError(f"export {tag}: wrote {sorted(names)}")
            export_matches_cpu(src, out, tmp / f"{tag}_cpu")
            game = replay_demo_game(out / "best_game.json")
            runs.append(dict(tag=tag, src=src.name, score=game["score"],
                             moves=len(game["moves"]), launches=launches, seconds=seconds))
        if json.loads((tmp / "c" / "best_game.json").read_text())["moves"] != \
                json.loads(game_a.read_text())["moves"]:
            raise AssertionError("export c: --game did not carry (a)'s moves")
    by_phase["export_demo"] = merge.launches - before
    a, b, c = runs
    if a["score"] < DEMO_SAMPLED_MIN_BEST:
        raise AssertionError(f"sampled best {a['score']} < {DEMO_SAMPLED_MIN_BEST}")
    if b["score"] < DEMO_SEARCH_MIN_BEST:
        raise AssertionError(f"search best {b['score']} < {DEMO_SEARCH_MIN_BEST}")
    if c["launches"] != 0:
        raise AssertionError(f"--game made {c['launches']} merge launches")
    # The exact rollout: one launch a trip and one for the fresh boards;
    # search play: the search's leaves and the step's next boards a trip,
    # and one for the fresh boards.
    a["trips"], b["trips"] = a["launches"] - 1, (b["launches"] - 1) // (search_merges(1) + 1)
    if (b["launches"] - 1) % (search_merges(1) + 1):
        raise AssertionError(f"search play: {b['launches']} merge launches")
    phase("export_demo", t0, "; ".join(
        f"({r['tag']}) {r['src']}: best game {r['score']} in {r['moves']} moves"
        + (f", {r['trips']} trips" if "trips" in r else " (--game of (a))")
        + f", merge launches {r['launches']}, {r['seconds']:.3f} s" for r in runs)
        + f"; model.onnx, model_weights.json, model_config.json == the CPU's; best games "
        f"replayed through the plain engine (floors {DEMO_SAMPLED_MIN_BEST} sampled, "
        f"{DEMO_SEARCH_MIN_BEST} search); merge launches {by_phase['export_demo']}")


def play_phase(by_phase: dict, device="cuda") -> None:
    """The terminal clients on the card: watch_agent on expA by depth-1
    search for one game, human_play on scripted keys."""
    t0 = time.perf_counter()
    before = merge.launches
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = play_cli.watch_agent(str(PLAY_SOURCE), delay=0.0, seed=0, search=1,
                                   device=device)
    sync(device)
    watch_s, watch_launches = time.perf_counter() - t0, merge.launches - before
    text = buf.getvalue()
    final = torch.as_tensor(out["final_board"], dtype=torch.int32)[None]
    if engine.all_moves(final).any_legal.any():
        raise AssertionError("watch_agent's game ended with a legal move left")
    score = int(engine.board_scores(final)[0])
    if f"Final Score: {score}\n" not in text or out["score"] != score:
        raise AssertionError(f"printed final score is not the board's {score}")
    grids = torch.as_tensor(np.array([g for g, _ in out["history"]]), dtype=torch.int32)
    acts = np.array([a for _, a in out["history"]])
    if not engine.all_moves(grids).legal.numpy()[acts, np.arange(len(acts))].all():
        raise AssertionError("watch_agent played an illegal move")
    printed = text.count("\nMove ")
    if printed != out["moves"] or watch_launches != 1 + 2 * out["moves"]:
        raise AssertionError(f"{out['moves']} moves: {printed} printed, {watch_launches} "
                             "merge launches")
    t1, start = time.perf_counter(), merge.launches
    keys = iter(HUMAN_KEYS)
    buf = io.StringIO()
    # No terminal to clear: the client's clear would write to the smoke's output.
    with contextlib.redirect_stdout(buf), mock.patch.object(play_cli, "_clear", lambda: None):
        human = play_cli.human_play(device=device, seed=0, get_key=lambda: next(keys))
    sync(device)
    human_s, human_launches = time.perf_counter() - t1, merge.launches - start
    htext = buf.getvalue()
    if human["moves"] < 5 or human_launches != 1 + human["moves"] or \
            "Thanks for playing" not in htext or "Invalid key" not in htext:
        raise AssertionError(f"human_play: {human['moves']} moves, {human_launches} merge "
                             "launches")
    by_phase["play"] = merge.launches - before
    phase("play", t0, f"watch_agent({PLAY_SOURCE.name}, search=1): {out['moves']} moves, "
          f"{out['points']} points, final score {score} (the tile sum: printed, the "
          "board's), every move legal, no move left, "
          f"{watch_s * 1e3 / out['moves']:.3f} host ms a move, merge launches "
          f"{watch_launches}; human_play on {len(HUMAN_KEYS)} scripted keys: "
          f"{human['moves']} moves, {human['points']} points, score "
          f"{int(engine.board_scores(torch.as_tensor(human['final_board'])[None])[0])}, "
          f"{human_s * 1e3 / human['moves']:.3f} host ms a move, merge launches "
          f"{human_launches}; merge launches {by_phase['play']}")


def warmstart_phase(by_phase: dict, device="cuda") -> None:
    """python -m tpu2048_torch.train.warmstart from expA at expert depths 0
    and 1; each train_state read back by the port trainer's loader."""
    t0 = time.perf_counter()
    before = merge.launches
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        src_sd = load_model_checkpoint(str(WARMSTART_SOURCE), device="cpu")[0].state_dict()
        for depth in (0, 1):
            t1, start = time.perf_counter(), merge.launches
            ck = Path(tmp) / f"d{depth}"
            with contextlib.redirect_stdout(io.StringIO()):
                mu, m2, n = warmstart.main(["--src-dir", str(WARMSTART_SOURCE),
                                            "--ckpt-dir", str(ck), *WARMSTART_FLAGS,
                                            "--expert-depth", str(depth), "--device", device])
            sync(device)
            seconds, launches = time.perf_counter() - t1, merge.launches - start
            model = load_model_checkpoint(str(WARMSTART_SOURCE), device=device)[0]
            opt_state, moments, key, manifest = loop.load_train_state(ck, model, device)
            sigma2 = float(moments.m2) - float(moments.mu) ** 2
            if manifest["train_step"] != 100 or manifest["highest_score"] != 40520:
                raise AssertionError(f"depth {depth}: manifest {manifest}")
            if not (math.isfinite(float(moments.mu)) and sigma2 > 0):
                raise AssertionError(f"depth {depth}: moments {moments}")
            if key.tolist() != WARMSTART_KEY or key.dtype != np.uint32:
                raise AssertionError(f"depth {depth}: key {key!r}")
            if opt_state.step != 0 or any(
                    bool(v.any()) for part in (opt_state.momentum, opt_state.m, opt_state.v)
                    for v in part.values()):
                raise AssertionError(f"depth {depth}: optimizer state not zero")
            for k, v in model.state_dict().items():
                if not torch.equal(v.cpu(), src_sd[k]):
                    raise AssertionError(f"depth {depth}: parameter {k} differs from the source")
            per_trip = 1 + (search_merges(depth) if depth else 0)
            trips, rest = divmod(launches - 1, per_trip)
            if rest:
                raise AssertionError(f"depth {depth}: {launches} merge launches")
            lines.append(f"depth {depth}: mu {mu:.3f}, sigma {math.sqrt(m2 - mu * mu):.3f} "
                         f"over {n} steps, {trips} trips, merge launches {launches}, "
                         f"{seconds:.3f} s")
    by_phase["warmstart"] = merge.launches - before
    phase("warmstart", t0, f"{WARMSTART_SOURCE.name} {' '.join(WARMSTART_FLAGS)}: "
          + "; ".join(lines) + "; each train_state read back by loop.load_train_state: "
          f"step 100, finite moments with sigma > 0, a zero optimizer state, key "
          f"{WARMSTART_KEY} (uint32), the source's parameters; merge launches "
          f"{by_phase['warmstart']}")


def models_phase(by_phase: dict, device="cuda") -> None:
    """python -m tpu2048_torch.models on the card."""
    t0 = time.perf_counter()
    before = merge.launches
    with contextlib.redirect_stdout(io.StringIO()):
        out = models_main.main(["--device", device])
    sync(device)
    by_phase["models"] = merge.launches - before
    counts = {k: out[k] for k in MODELS_PARAMS}
    if counts != MODELS_PARAMS:
        raise AssertionError(f"parameter counts {counts}, the JAX package's {MODELS_PARAMS}")
    for k in ("logits", "urm_logits"):
        if tuple(out[k].shape) != (3, 4) or not torch.isfinite(out[k]).all():
            raise AssertionError(f"{k}: {out[k]}")
    phase("models", t0, f"3 fresh boards through GameMLP and GameURM (H=64): logits (3, 4) "
          f"finite, parameter counts {counts} == the JAX package's; merge launches "
          f"{by_phase['models']}")


def scaling_rows_text(rows: list) -> str:
    return "; ".join(
        f"{r['mode']} D={r['mesh']} ({r['backend']}{', shared card' if r['shared_card'] else ''}): "
        f"{r['env_steps_per_s']:.1f} env steps/s (runs "
        + ", ".join(f"{x:.1f}" for x in r["env_steps_per_s_runs"])
        + f"; spread {r['spread'] * 100:.2f}%; host s a step "
        + ", ".join(f"{x['seconds']:.3f}" for x in r["runs"])
        + f", the first {bench_scaling.WARMUP} untimed), efficiency "
        f"{r['weak_scaling_efficiency']:.4f} against {r['mesh']}x D=1's env steps/s, merge "
        f"launches {r['launches']}" for r in rows)


def check_scaling_row(r: dict, envs: int) -> None:
    """A row's step counts and merge launches, from its runs: packed, two
    launches a trip of every rank; exact, one a trip plus one (each rank
    runs its own games: the launches lie between one rank's and every
    rank's count of the longest game's trips)."""
    steps = bench_scaling.WARMUP + SCALING_REPEATS
    runs = r["runs"]
    if len(runs) != steps or sum(x["timed"] for x in runs) != SCALING_REPEATS:
        raise AssertionError(f"{r['mode']} D={r['mesh']}: {len(runs)} steps")
    lanes = envs * r["mesh"]
    if r["mode"] == "packed":
        want = r["ranks"] * 2 * SCALING_HORIZON * steps
        if r["launches"] != want or any(x["env_steps"] != lanes * SCALING_HORIZON
                                        for x in runs):
            raise AssertionError(f"packed D={r['mesh']}: {r['launches']} merge launches "
                                 f"(expected {want}), env steps {[x['env_steps'] for x in runs]}")
    else:
        one = sum(x["trips"] + 1 for x in runs)
        if not one <= r["launches"] <= r["ranks"] * one or r["ranks"] == 1 and r["launches"] != one:
            raise AssertionError(f"exact D={r['mesh']}: {r['launches']} merge launches for "
                                 f"trips {[x['trips'] for x in runs]}")
        if any(not lanes <= x["env_steps"] <= lanes * x["trips"] for x in runs):
            raise AssertionError(f"exact D={r['mesh']}: env steps {runs}")
    if not all(math.isfinite(x) and x > 0 for x in r["env_steps_per_s_runs"]):
        raise AssertionError(f"{r['mode']} D={r['mesh']}: rates {r['env_steps_per_s_runs']}")


def scaling_phase(by_phase: dict, device="cuda", envs: int = SCALING_ENVS) -> None:
    """scripts/torch_bench_scaling.py at D = 1 (in this process) and D = 2
    (spawned ranks), both on the one card over Gloo when there is one card;
    each row's launches and env steps checked against its runs."""
    t0 = time.perf_counter()
    before = merge.launches
    share = torch.device(device).type == "cuda" and torch.cuda.device_count() < 2
    rows = bench_scaling.run([1, 2], SCALING_MODES, envs_per_device=envs,
                             horizon=SCALING_HORIZON, repeats=SCALING_REPEATS, device=device,
                             share_card=share, say=lambda s: None)
    for r in rows:
        check_scaling_row(r, envs)
    local = sum(r["launches"] for r in rows if r["mesh"] == 1)
    if local != merge.launches - before:
        raise AssertionError(f"D=1 rows' {local} merge launches vs "
                             f"{merge.launches - before} counted here")
    REMOTE_LAUNCHES["scaling"] = sum(r["launches"] for r in rows if r["mesh"] > 1)
    by_phase["scaling"] = local + REMOTE_LAUNCHES["scaling"]
    phase("scaling", t0, f"scripts/torch_bench_scaling.py, MLP H=196x2, {envs} games or "
          f"lanes a rank, {bench_scaling.WARMUP} warm-up + {SCALING_REPEATS} timed steps a "
          "row" + (f" [{bench_scaling.NO_SCALING}]" if share else "") + ": "
          + scaling_rows_text(rows) + f"; merge launches {by_phase['scaling']}")


def prune_bias_phase(by_phase: dict, device="cuda", n: int = PRUNE_BOARDS,
                     depth: int = PRUNE_DEPTH) -> None:
    """scripts/torch_prune_bias.py on PRUNE_CHECKPOINT: the exact and pruned
    searches' scores where legal, pruning never raising a score, the peak
    memory within the cap, the first board's k=2 scores against the CPU,
    the launches."""
    t0 = time.perf_counter()
    before = merge.launches
    lines = []
    out = prune_bias.prune_bias(PRUNE_CHECKPOINT, n, depth, device, say=lines.append)
    sync(device)
    by_phase["prune_bias"] = merge.launches - before
    legal, exact = out["legal"], out["exact"]
    scored = [exact] + list(out["pruned"].values())
    if any(not np.array_equal(np.isfinite(s), legal) for s in scored) or not legal.any(1).all():
        raise AssertionError("prune_bias: scores finite other than where legal")
    for k, p in out["pruned"].items():  # a max over fewer actions, positive weights
        if (p[legal] > exact[legal] + SEARCH_TOL * np.maximum(1.0, np.abs(exact[legal]))).any():
            raise AssertionError(f"prune_k={k}: a pruned score above the exact one")
    if out["peak_bytes"] is not None and out["peak_bytes"] > out["cap_bytes"]:
        raise AssertionError(f"peak {out['peak_bytes']} B above the cap {out['cap_bytes']} B")
    cpu_model = load_model_checkpoint(str(PRUNE_CHECKPOINT), device="cpu")[0]
    coefs = load_search_coefs(str(PRUNE_CHECKPOINT))
    cpu = prune_bias.root_scores(cpu_model, out["boards"][:1], coefs, depth, 2, 1)
    cpu_err = assert_close("prune_bias k=2 card vs CPU", np.where(legal[:1], out["pruned"][2][:1],
                                                                   np.nan),
                           np.where(legal[:1], cpu, np.nan), SEARCH_TOL)
    chunks = -(-len(out["boards"]) // out["chunk"])
    search = chunks * (1 + search_merges(depth)
                       + len(out["pruned"]) * (1 + search_merges(depth, pruned=True)))
    rollout = by_phase["prune_bias"] - search - 1  # and one for the boards' legality
    if not 2 <= rollout <= prune_bias.GAME_CAP + 1:
        raise AssertionError(f"{by_phase['prune_bias']} merge launches: {search} expected "
                             f"in the searches and 1 in the legality, {rollout} left for "
                             "the greedy games")
    phase("prune_bias", t0, " | ".join(lines) + f" | k=2 card == CPU on the first board (max "
          f"|diff| {cpu_err:.3g}, tol {SEARCH_TOL}); pruned <= exact; "
          f"merge launches {by_phase['prune_bias']} ({rollout} in the greedy games, {search} "
          f"in {chunks} chunk(s) of searches)")


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
    train_dp_phase(by_phase)
    train_urm_phase(by_phase)
    train_exact_phase(by_phase)
    train_expert_phase(by_phase)
    train_expert_live_phase(by_phase)
    export_demo_phase(by_phase)
    play_phase(by_phase)
    warmstart_phase(by_phase)
    models_phase(by_phase)
    scaling_phase(by_phase)
    prune_bias_phase(by_phase)

    # 21. kernels
    t0 = time.perf_counter()
    main_launches = merge.launches + sum(REMOTE_LAUNCHES.values())
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
