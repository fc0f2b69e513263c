"""Board -> model-input encoding (counterpart of ``tpu2048/models/encoding.py``).

A flat 48-vector per board: for each cell in row-major order, (raw exponent,
row/3, col/3). Exponents are not normalised; only the positions are scaled
into [0, 1].
"""

from __future__ import annotations

import torch

from .. import GRID_SIZE, NUM_CELLS

INPUT_DIM = NUM_CELLS * 3


def encode_boards(boards: torch.Tensor) -> torch.Tensor:
    """(...B, 4, 4) int -> (...B, 48) float32 model input."""
    batch = boards.shape[:-2]
    flat = boards.reshape(batch + (NUM_CELLS,)).to(torch.float32)
    # Positions divided in float64, then rounded once to float32.
    idx = torch.arange(NUM_CELLS, dtype=torch.float64, device=boards.device)
    rows = (torch.div(idx, GRID_SIZE, rounding_mode="floor") / 3.0).float()
    cols = (torch.remainder(idx, GRID_SIZE) / 3.0).float()
    rows, cols = rows.expand_as(flat), cols.expand_as(flat)
    return torch.stack([flat, rows, cols], dim=-1).reshape(batch + (INPUT_DIM,))
