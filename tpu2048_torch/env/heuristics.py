"""The board heuristics (counterpart of ``tpu2048/env/heuristics.py``).

Functions over ``(...B, 4, 4)`` int32 exponent boards. ``monotonicity`` and
``emptiness`` are the two PBRS potentials of the live reward and of the
search's ``phi`` (``algo/search.py``); the rest are logging signals, computed
for one episode at print cadence (the episode breakdown and the viz JSON).

``monotonic_chain_score`` is the reference's depth-first search re-derived
as a dynamic program over the 16 exponent levels (chain values descend by
exactly one, so the search's visited set never triggers). Where the
reference takes the first maximum or minimum (row-major max tile, corner
order), the port picks the least index explicitly, whatever order a device's
argmax takes among equal values.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import GRID_SIZE, NUM_CELLS

# Corner flat indices in row-major scan order: (0,0) (0,3) (3,0) (3,3).
_CORNER_FLAT = (0, 3, 12, 15)
_CORNER_COORDS = ((0, 0), (0, 3), (3, 0), (3, 3))
_NEIGHBOR_SHIFTS = ((-1, 0), (1, 0), (0, -1), (0, 1))
HIGH_EXPONENT = 5  # adjacency bonus: pairs of tiles >= 32


def snake_order(corner: tuple) -> list:
    """Boustrophedon path of (row, col) cells from a corner."""
    cr, cc = corner
    row_dir = 1 if cr == 0 else -1
    col_dir = 1 if cc == 0 else -1
    order = []
    for i in range(GRID_SIZE):
        cols = list(range(cc, cc + GRID_SIZE * col_dir, col_dir))
        if i % 2 == 1:
            cols.reverse()
        order.extend((cr + i * row_dir, col) for col in cols)
    return order


# Per corner: snake position -> flat cell, and flat cell -> snake position.
_SNAKE_ORDER = [[r * GRID_SIZE + c for r, c in snake_order(corner)]
                for corner in _CORNER_COORDS]
_SNAKE_INDEX = [[order.index(cell) for cell in range(NUM_CELLS)]
                for order in _SNAKE_ORDER]


def _table(rows, device) -> torch.Tensor:
    return torch.tensor(rows, dtype=torch.int64, device=device)


def _flat(boards: torch.Tensor) -> torch.Tensor:
    return boards.reshape(boards.shape[:-2] + (NUM_CELLS,))


def _neighbor(boards: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """Value of the (di, dj)-neighbour of each cell, 0 outside the board."""
    padded = F.pad(boards, (1, 1, 1, 1))
    return padded[..., 1 + di:1 + di + GRID_SIZE, 1 + dj:1 + dj + GRID_SIZE]


def _first_index(mask: torch.Tensor) -> torch.Tensor:
    """Least index along the last axis where ``mask`` holds (0 where it
    holds nowhere, as ``argmax`` of an all-False row)."""
    n = mask.shape[-1]
    idx = torch.arange(n, device=mask.device).expand_as(mask)
    first = torch.where(mask, idx, n).amin(-1)
    return torch.where(first == n, 0, first)


def first_max_index(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along the last axis (of each (..., 16) row
    of cells, the first max cell in row-major order), on the device."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device).expand_as(x)
    return torch.where(x == x.amax(-1, keepdim=True), idx, n).amin(-1)


def emptiness(boards: torch.Tensor) -> torch.Tensor:
    """Number of empty cells, int32."""
    return (boards == 0).sum((-1, -2), dtype=torch.int32)


def smoothness(boards: torch.Tensor) -> torch.Tensor:
    """-sum of |exponent difference| over adjacent non-empty pairs, float32."""
    h_l, h_r = boards[..., :, :-1], boards[..., :, 1:]
    v_t, v_b = boards[..., :-1, :], boards[..., 1:, :]
    h = torch.where((h_l > 0) & (h_r > 0), (h_l - h_r).abs(), 0)
    v = torch.where((v_t > 0) & (v_b > 0), (v_t - v_b).abs(), 0)
    return -(h.sum((-1, -2)) + v.sum((-1, -2))).to(torch.float32)


def corner_bonus(boards: torch.Tensor) -> torch.Tensor:
    """+max exponent if any max tile is in a corner, else -max exponent; 0
    for an empty board. float32."""
    flat = _flat(boards)
    m = flat.amax(-1)
    in_corner = (flat[..., list(_CORNER_FLAT)] == m[..., None]).any(-1)
    out = torch.where(in_corner, m, -m).to(torch.float32)
    return torch.where(m > 0, out, 0.0)


def adjacency_bonus(boards: torch.Tensor) -> torch.Tensor:
    """Half the neighbours' exponents of the first max tile, plus a quarter
    of the exponent sum of every adjacent pair of tiles >= 32. float32."""
    idx = first_max_index(_flat(boards))
    onehot = (torch.arange(NUM_CELLS, device=boards.device) == idx[..., None])
    onehot_grid = onehot.reshape(boards.shape).to(torch.float32)
    nb_sum = torch.zeros(boards.shape[:-2], dtype=torch.float32, device=boards.device)
    for di, dj in _NEIGHBOR_SHIFTS:
        nb = _neighbor(boards, di, dj).to(torch.float32)
        nb_sum = nb_sum + (onehot_grid * nb * 0.5).sum((-1, -2))
    h_l, h_r = boards[..., :, :-1], boards[..., :, 1:]
    v_t, v_b = boards[..., :-1, :], boards[..., 1:, :]
    h = torch.where((h_l >= HIGH_EXPONENT) & (h_r >= HIGH_EXPONENT),
                    (h_l + h_r) * 0.25, 0.0)
    v = torch.where((v_t >= HIGH_EXPONENT) & (v_b >= HIGH_EXPONENT),
                    (v_t + v_b) * 0.25, 0.0)
    return nb_sum + h.sum((-1, -2)) + v.sum((-1, -2))


def monotonic_chain_score(boards: torch.Tensor) -> torch.Tensor:
    """Best exactly-descending chain score from a max tile, float32: f(cell)
    = v + the best f of a neighbour holding v - 1, for v = 1..16; the answer
    is the best f over the max cells."""
    f = torch.zeros(boards.shape, dtype=torch.float32, device=boards.device)
    neighbors = [_neighbor(boards, di, dj) for di, dj in _NEIGHBOR_SHIFTS]
    for v in range(1, 17):
        best_nb = torch.zeros_like(f)
        for (di, dj), nb_val in zip(_NEIGHBOR_SHIFTS, neighbors):
            nb_f = _neighbor(f, di, dj)
            best_nb = torch.maximum(best_nb, torch.where(nb_val == v - 1, nb_f, 0.0))
        f = torch.where(boards == v, v + best_nb, f)
    m = boards.amax((-1, -2))
    out = torch.where(boards == m[..., None, None], f, 0.0).amax((-1, -2))
    return torch.where(m > 0, out, 0.0)


def _ordered_pairs(lo: torch.Tensor, hi: torch.Tensor) -> tuple:
    """Counts of adjacent pairs (``lo``, ``hi``), both nonzero, with lo>=hi
    and with lo<=hi."""
    both = (lo > 0) & (hi > 0)
    return ((both & (lo >= hi)).sum((-1, -2), dtype=torch.int32),
            (both & (lo <= hi)).sum((-1, -2), dtype=torch.int32))


def monotonicity(boards: torch.Tensor) -> torch.Tensor:
    """Best ordered-pair count over the 4 rotations, then x2 if the FIRST max
    tile (row-major scan) is in a corner, else //2 (the reference's
    first-max quirk). int32.

    The reference counts, for each rotation, the nonzero adjacent pairs with
    left>=right plus those with top>=bottom. A quarter turn maps the
    horizontal pairs onto the vertical ones and back, so the four rotations
    count H+ + V+, H+ + V-, H- + V- and H- + V+ (H+: left>=right, H-:
    left<=right, V+: top>=bottom, V-: top<=bottom), and their best is
    max(H+, H-) + max(V+, V-): the same integer in far fewer operations."""
    h_ge, h_le = _ordered_pairs(boards[..., :, :-1], boards[..., :, 1:])
    v_ge, v_le = _ordered_pairs(boards[..., :-1, :], boards[..., 1:, :])
    best = torch.maximum(h_ge, h_le) + torch.maximum(v_ge, v_le)
    idx = first_max_index(_flat(boards))
    row, col = idx // 4, idx % 4
    in_corner = ((row == 0) | (row == 3)) & ((col == 0) | (col == 3))
    return torch.where(in_corner, best * 2, best // 2)


def choose_anchor_corner(boards: torch.Tensor) -> torch.Tensor:
    """Anchor corner (0..3, scan order of the corners) per board, int32: the
    first corner holding a max tile, else the corner nearest (Manhattan) to
    the first max tile, ties to the lower index."""
    flat = _flat(boards)
    m = flat.amax(-1)
    corner_has_max = (flat[..., list(_CORNER_FLAT)] == m[..., None]) & (m[..., None] > 0)
    first_corner = _first_index(corner_has_max)
    idx = first_max_index(flat)
    coords = _table(_CORNER_COORDS, boards.device)
    dist = ((coords[:, 0] - (idx // GRID_SIZE)[..., None]).abs()
            + (coords[:, 1] - (idx % GRID_SIZE)[..., None]).abs())
    nearest = _first_index(dist == dist.amin(-1, keepdim=True))
    return torch.where(corner_has_max.any(-1), first_corner, nearest).to(torch.int32)


def topological_score(boards: torch.Tensor, anchor: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """Snake-gradient organisation score, float32. ``anchor``: (...B,) corner
    index per board; None gives the best over the four corners."""
    if anchor is None:
        scores = [topological_score(boards, torch.full(boards.shape[:-2], ci,
                                                       dtype=torch.int32,
                                                       device=boards.device))
                  for ci in range(4)]
        return torch.stack(scores).amax(0)
    anchor = anchor.long()
    flat = _flat(boards).to(torch.float32)
    m = flat.amax(-1)
    snake_index = _table(_SNAKE_INDEX, boards.device)[anchor]  # cell -> position
    snake_order = _table(_SNAKE_ORDER, boards.device)[anchor]  # position -> cell

    # 1. Position bonus: (16 - position) * value * 0.1 over nonzero cells,
    # summed cell by cell in row-major order (the order of the JAX
    # package's float32 reduction on the CPU, so the score is bit-exact).
    terms = (16.0 - snake_index) * flat * 0.1 * (flat > 0)
    score = terms[..., 0]
    for cell in range(1, NUM_CELLS):
        score = score + terms[..., cell]

    # 2. Monotonic bonus / inversion penalty along the snake, skipping zeros.
    along = torch.gather(flat, -1, snake_order)
    prev = torch.full(boards.shape[:-2], float("inf"), device=boards.device)
    for k in range(NUM_CELLS):
        val = along[..., k]
        present = val > 0
        inc = torch.where(val <= prev, val * 0.2, -(val - prev) * 0.5)
        score = score + torch.where(present, inc, 0.0)
        prev = torch.where(present, val, prev)

    # 3. Max tile anchored in the chosen corner.
    corner_cell = _table(_CORNER_FLAT, boards.device)[anchor]
    corner_val = torch.gather(flat, -1, corner_cell[..., None])[..., 0]
    score = score + torch.where((corner_val == m) & (m > 0), m * 2.0, 0.0)

    # 4. Trapped-tile penalty for exponent >= 4 tiles late in the snake.
    total = torch.zeros_like(boards)
    lower = torch.zeros_like(boards)
    for di, dj in _NEIGHBOR_SHIFTS:
        nb = _neighbor(boards, di, dj)
        total = total + (nb > 0).to(boards.dtype)
        lower = lower + ((nb > 0) & (nb < boards - 2)).to(boards.dtype)
    trapped = ((boards >= 4) & (total >= 2) & (lower >= total - 1)
               & (snake_index.reshape(boards.shape) > 4))
    score = score - torch.where(trapped, boards, 0).sum((-1, -2)).to(torch.float32)
    return torch.where(m > 0, score, 0.0)


def live_potentials(boards: torch.Tensor) -> tuple:
    """(monotonicity, emptiness): the two PBRS potentials of the live reward."""
    return monotonicity(boards), emptiness(boards)


def full_suite(boards: torch.Tensor, anchor: torch.Tensor | None = None) -> dict:
    """Every heuristic at once, float32 (print cadence and parity tests)."""
    if anchor is None:
        anchor = choose_anchor_corner(boards)
    return {
        "smoothness": smoothness(boards),
        "corner": corner_bonus(boards),
        "adjacency": adjacency_bonus(boards),
        "chain": monotonic_chain_score(boards),
        "monotonicity": monotonicity(boards).to(torch.float32),
        "emptiness": emptiness(boards).to(torch.float32),
        "topological": topological_score(boards, anchor),
    }
