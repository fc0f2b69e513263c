"""The board heuristics behind the PBRS shaping (counterpart of the
``monotonicity`` and ``emptiness`` part of ``tpu2048/env/heuristics.py``).

Integer functions over ``(...B, 4, 4)`` int32 exponent boards; the search's
potential ``phi`` (``algo/search.py``) is built from them. The rest of the
reference's suite (logging signals) is not ported yet.
"""

from __future__ import annotations

import torch

from .. import NUM_CELLS


def emptiness(boards: torch.Tensor) -> torch.Tensor:
    """Number of empty cells, int32."""
    return (boards == 0).sum((-1, -2), dtype=torch.int32)


def _ordered_pairs(lo: torch.Tensor, hi: torch.Tensor) -> tuple:
    """Counts of adjacent pairs (``lo``, ``hi``), both nonzero, with lo>=hi
    and with lo<=hi."""
    both = (lo > 0) & (hi > 0)
    return ((both & (lo >= hi)).sum((-1, -2), dtype=torch.int32),
            (both & (lo <= hi)).sum((-1, -2), dtype=torch.int32))


def _first_max_index(flat: torch.Tensor) -> torch.Tensor:
    """Flat index of the first (row-major) max cell of each (..., 16) row:
    the least index holding the max, whatever order a device's argmax takes
    among equal values."""
    at_max = flat == flat.amax(-1, keepdim=True)
    idx = torch.arange(NUM_CELLS, device=flat.device).expand_as(flat)
    return torch.where(at_max, idx, NUM_CELLS).amin(-1)


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
    idx = _first_max_index(boards.reshape(boards.shape[:-2] + (NUM_CELLS,)))
    row, col = idx // 4, idx % 4
    in_corner = ((row == 0) | (row == 3)) & ((col == 0) | (col == 3))
    return torch.where(in_corner, best * 2, best // 2)
