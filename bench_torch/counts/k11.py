"""K11, the cube's all-pairs search: bytes of the function -- positions
read, partners written -- against the pair tests that a cell grid of side
w = 1.001 r needs on this data (``chip_smoke``'s K11 bound and
``allpairs_cell_tests``)."""

from __future__ import annotations

import torch

from .cells import cell_side, grid_tests
from .roofline import PAIR_TEST_OPS, bound


def bound_ms(pos: torch.Tensor, r: float) -> tuple:
    n = pos.shape[0]
    return bound(n * 12 + n * 4,
                 PAIR_TEST_OPS * grid_tests(pos, cell_side(r)))
