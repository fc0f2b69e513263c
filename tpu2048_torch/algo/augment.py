"""Symmetry data augmentation: the plan (counterpart of
``tpu2048/algo/augment.py::plan``).

``num_slots`` slots draw a source row uniformly among the valid rows, with
replacement; each slot yields a mirror candidate (kept with probability 1/2,
a horizontal or vertical mirror) and a rotation candidate (kept with
probability 1/2, 90/180/270 degrees). Only the first ``num_to_sample`` slots
are used. The plan says which rows to transform and how; the learner
(``algo/update.py``) makes each minibatch's augmented rows from it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..env import symmetry


class AugPlan(NamedTuple):
    src: torch.Tensor  # (A,) int64 source row in the real flat arrays
    transform: torch.Tensor  # (A,) int64 symmetry transform id
    valid: torch.Tensor  # (A,) bool


def plan(generator: torch.Generator, num_slots: int, num_to_sample: torch.Tensor,
         flat_valid: torch.Tensor) -> AugPlan:
    """The augmentation plan for ``flat_valid`` (S,) rows; A = 2 * num_slots
    (the mirror candidates, then the rotation candidates). ``num_to_sample``
    is a tensor on the rows' device, so the plan needs no host sync."""
    device = flat_valid.device

    def uniform():
        return torch.rand(num_slots, generator=generator, device=device)

    n_valid = flat_valid.sum().clamp(min=1)
    # A stable sort packs the valid rows to the front; each slot then draws
    # a uniform rank among them.
    order = torch.argsort((~flat_valid).to(torch.int8), stable=True)
    ranks = torch.minimum((uniform() * n_valid).long(), n_valid - 1)
    src = order[ranks]
    slot_used = torch.arange(num_slots, device=device) < num_to_sample
    mirror_flag = uniform() < 0.5
    mirror_tf = torch.where(uniform() < 0.5, symmetry.MIRROR_H, symmetry.MIRROR_V)
    rotate_flag = uniform() < 0.5
    rotate_tf = torch.randint(symmetry.ROT90, symmetry.ROT270 + 1, (num_slots,),
                              generator=generator, device=device)
    src2 = torch.cat([src, src])
    valid = torch.cat([slot_used & mirror_flag, slot_used & rotate_flag])
    return AugPlan(src=src2, transform=torch.cat([mirror_tf, rotate_tf]),
                   valid=valid & flat_valid[src2])
