"""The fused four-direction merge: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``tpu2048/ops/pallas_merge.py`` (the Pallas TPU kernel
``merge_left_all_dirs`` and its wrapper ``all_moves``). Both functions here
take ``(N, 4, 4)`` int32 exponent boards and return the four ``MoveSet``
fields ``(boards (4,N,4,4) int32, scores (4,N) int32, max_created (4,N)
int32, legal (4,N) bool)``, directions 0=UP 1=DOWN 2=LEFT 3=RIGHT:

* :func:`merge4_cuda` launches ``csrc/merge4.cu`` (built by ``_build``) on a
  CUDA tensor and raises on anything else;
* :func:`merge4_plain` is the same function in plain tensor ops, for CPU
  tensors and as the reference the kernel is held against.

``env.engine.all_moves`` picks between them by the tensor's device.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

# Launches of the CUDA kernel in this process; a run sets it to 0 and reads
# it back to show that its path went through the kernel.
launches = 0
_count_lock = threading.Lock()

_SIGNATURES = {
    "merge4_launch": (ctypes.c_int, [ctypes.c_void_p] * 5
                      + [ctypes.c_int64, ctypes.c_void_p]),
    "merge4_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def build() -> _build.Built:
    """Build (at first use) and load the kernel library."""
    return _build.load("merge4", _SIGNATURES)


def merge_lines_left(lines: torch.Tensor) -> tuple:
    """Slide and merge leftward along the last axis (length 4).

    ``lines``: (..., 4) int32 exponents. Returns (merged (..., 4),
    score (...), max_created (...)): left priority, each tile merges at most
    once, score = sum of the created tiles' values. The same three-pass
    compaction, merge sweep and compaction as the JAX engine's."""
    v = list(lines.unbind(-1))
    zero = torch.zeros_like(v[0])

    def compress(v):
        for _ in range(3):
            for i in range(3):
                hole = v[i] == 0
                v[i], v[i + 1] = (torch.where(hole, v[i + 1], v[i]),
                                  torch.where(hole, zero, v[i + 1]))
        return v

    v = compress(v)
    score = torch.zeros_like(v[0])
    max_created = torch.zeros_like(v[0])
    for i in range(3):
        m = (v[i] != 0) & (v[i] == v[i + 1])
        new_exp = v[i] + 1
        score = score + torch.where(m, torch.ones_like(new_exp) << new_exp, zero)
        max_created = torch.maximum(max_created, torch.where(m, new_exp, zero))
        v[i] = torch.where(m, new_exp, v[i])
        v[i + 1] = torch.where(m, zero, v[i + 1])
    v = compress(v)
    return torch.stack(v, dim=-1), score, max_created


def _check(boards: torch.Tensor) -> None:
    if boards.dtype != torch.int32:
        raise TypeError(f"boards must be int32, got {boards.dtype}")
    if boards.dim() != 3 or tuple(boards.shape[1:]) != (4, 4):
        raise ValueError(f"boards must be (N, 4, 4), got {tuple(boards.shape)}")
    if not boards.is_contiguous():
        raise ValueError("boards must be contiguous")


def merge4_plain(boards: torch.Tensor) -> tuple:
    """The kernel's function in plain tensor ops, on any device: every
    direction is a leftward merge of a transposed or reversed view (UP =
    columns, DOWN = reversed columns, LEFT = rows, RIGHT = reversed rows)."""
    _check(boards)
    cols = boards.transpose(-1, -2)
    lines = torch.stack([cols, cols.flip(-1), boards, boards.flip(-1)])
    merged, line_scores, line_max = merge_lines_left(lines)
    out = torch.stack([merged[0].transpose(-1, -2),
                       merged[1].flip(-1).transpose(-1, -2),
                       merged[2], merged[3].flip(-1)])
    scores = line_scores.sum(-1, dtype=torch.int32)
    legal = (out != boards[None]).flatten(2).any(-1)
    return out, scores, line_max.amax(-1), legal


def merge4_cuda(boards: torch.Tensor) -> tuple:
    """Launch the CUDA kernel on ``boards``, a contiguous (N, 4, 4) int32
    CUDA tensor, on the current stream; does not synchronise. Raises on any
    other input, and if the launch is refused."""
    global launches
    if not boards.is_cuda:
        raise ValueError(
            f"merge4_cuda takes a CUDA tensor, got one on {boards.device} "
            "(merge4_plain is the CPU version)")
    _check(boards)
    if boards.data_ptr() % 16:
        raise ValueError("boards must be 16-byte aligned")
    n = boards.shape[0]
    dev = boards.device
    out = torch.empty((4, n, 4, 4), dtype=torch.int32, device=dev)
    scores = torch.empty((4, n), dtype=torch.int32, device=dev)
    max_created = torch.empty((4, n), dtype=torch.int32, device=dev)
    legal = torch.empty((4, n), dtype=torch.bool, device=dev)
    if n == 0:
        return out, scores, max_created, legal
    lib = build().lib
    with torch.cuda.device(dev):
        rc = lib.merge4_launch(
            boards.data_ptr(), out.data_ptr(), scores.data_ptr(),
            max_created.data_ptr(), legal.data_ptr(), n,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"merge4 kernel launch failed: {lib.merge4_error_string(rc).decode()}"
            f" (cudaError {rc})")
    with _count_lock:
        launches += 1
    return out, scores, max_created, legal
