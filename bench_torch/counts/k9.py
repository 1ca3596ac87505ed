"""K9, the sweep's partner search: float32 operations of the pair tests
that the finest cell grid able to find every partner within the collision
range r needs on the state (``cells.grid_tests`` at ``cells.cell_side``,
as K11's count), against the bytes of its result: positions read,
partners written.  The grid the program chooses does not enter."""

from __future__ import annotations

import torch

from .cells import cell_side, grid_tests
from .roofline import PAIR_TEST_OPS, bound


def bound_ms(pos: torch.Tensor, r: float) -> tuple:
    n = pos.shape[0]
    return bound(n * 12 + n * 4, PAIR_TEST_OPS * grid_tests(pos, cell_side(r)))
