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
# it back to show that its path went through the kernel. A replay of a CUDA
# graph that captured a launch does not pass through the wrapper and is not
# counted.
launches = 0
_count_lock = threading.Lock()

_SIGNATURES = {
    "merge4_launch": (ctypes.c_int, [ctypes.c_void_p] * 5
                      + [ctypes.c_int64, ctypes.c_void_p, ctypes.c_int]),
    "merge4_path_thresholds": (None, [ctypes.POINTER(ctypes.c_int64)] * 2),
    "merge4_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
# merge4_launch's `path`: the kernel picks by N, or is told which design to
# run (for measurement and for checking each on the card): the small-N
# design, or the streaming design on tiles of 64 or 128 boards.
PATHS = {"auto": 0, "small": 1, "stream64": 2, "stream128": 3}
# 4-byte words per board of the four outputs: boards 4x64 B, scores 4x4 B,
# max_created 4x4 B, legal 4x1 B.
_WORDS_PER_BOARD = (256 + 16 + 16 + 4) // 4

_launch = None  # merge4_launch of the loaded library, looked up once


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


def path_thresholds() -> tuple:
    """The N at which the kernel moves to its streaming design, and to that
    design's 128-board tiles."""
    stream_min, wide_min = ctypes.c_int64(), ctypes.c_int64()
    build().lib.merge4_path_thresholds(ctypes.byref(stream_min), ctypes.byref(wide_min))
    return stream_min.value, wide_min.value


def alloc_outputs(n: int, device) -> tuple:
    """The four ``MoveSet`` fields of ``n`` boards as views of one buffer on
    ``device``: boards (4,n,4,4) int32, scores (4,n) int32, max_created
    (4,n) int32 and legal (4,n) bool (1 byte each), in that order and each
    at a 16-byte-aligned offset (256n, 272n and 288n bytes). One allocation
    and four ``as_strided`` views are the cheapest of the layouts timed on
    the host (``scripts/torch_profile.py``)."""
    words = torch.empty(_WORDS_PER_BOARD * n, dtype=torch.int32, device=device)
    return (words.as_strided((4, n, 4, 4), (16 * n, 16, 4, 1)),
            words.as_strided((4, n), (n, 1), 64 * n),
            words.as_strided((4, n), (n, 1), 68 * n),
            words.view(torch.bool).as_strided((4, n), (n, 1), 288 * n))


def merge4_cuda(boards: torch.Tensor, path: str = "auto") -> tuple:
    """Launch the CUDA kernel on ``boards``, a contiguous (N, 4, 4) int32
    CUDA tensor, on the current stream; does not synchronise. Raises on any
    other input, and if the launch is refused.

    The four fields returned are views of one buffer (:func:`alloc_outputs`):
    a caller that keeps one of them keeps the whole buffer alive. ``path``
    (a key of ``PATHS``) forces one of the kernel's designs; the default
    lets it pick by N. The launch is captured by ``torch.cuda.graph`` like
    any work on the current stream; ``launches`` counts calls of this
    function, not replays of a graph."""
    global launches, _launch
    if not boards.is_cuda:
        raise ValueError(
            f"merge4_cuda takes a CUDA tensor, got one on {boards.device} "
            "(merge4_plain is the CPU version)")
    _check(boards)
    if boards.data_ptr() % 16:
        raise ValueError("boards must be 16-byte aligned")
    idx = boards.device.index
    if idx != torch.cuda.current_device():
        with torch.cuda.device(idx):
            return merge4_cuda(boards, path)
    n = boards.shape[0]
    fields = alloc_outputs(n, boards.device)
    if n == 0:
        return fields
    if _launch is None:
        _launch = build().lib.merge4_launch
    # The raw handle of the current stream: what torch.cuda.current_stream()
    # .cuda_stream gives, without building a Stream object (4 us a call).
    rc = _launch(boards.data_ptr(), *(t.data_ptr() for t in fields), n,
                 torch._C._cuda_getCurrentRawStream(idx), PATHS[path])
    if rc != 0:
        raise RuntimeError(
            f"merge4 kernel launch failed: "
            f"{build().lib.merge4_error_string(rc).decode()} (error {rc})")
    with _count_lock:
        launches += 1
    return fields
