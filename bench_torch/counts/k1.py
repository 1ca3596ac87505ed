"""K1, the pairs rebuild's half-shell sweep, by the work alone: positions
and reach radii read (16 bytes a particle), each particle's entry of a
cell table read once (4), and one candidate index written for each pair
whose spheres of reach overlap (``cells.pairs_within``).  The program's
padding, capacities and ``top_k`` do not enter; ``chip_smoke``'s count
of the same call, with its padded table and slot planes, is larger (held
so by ``tests/test_counts.py``)."""

from __future__ import annotations

import torch

from .cells import pairs_within
from .roofline import bound


def reach_radii(vel: torch.Tensor, cr: float, dt: float,
                k_steps: int) -> torch.Tensor:
    """reach_i = cr/2 + |v_i| K dt: how far a particle's sphere reaches in
    the K steps a pair list serves (the reference's pairs.py:135-140)."""
    speed = torch.sqrt((vel.double() * vel.double()).sum(dim=1))
    return (0.5 * cr + speed * (dt * k_steps)).to(vel.dtype)


def bytes_moved(n: int, pairs: int) -> int:
    return n * (12 + 4) + n * 4 + pairs * 4


def bound_ms(pos: torch.Tensor, vel: torch.Tensor, cr: float, dt: float,
             k_steps: int) -> tuple:
    pairs = pairs_within(pos, reach_radii(vel, cr, dt, k_steps))
    return bound(bytes_moved(pos.shape[0], pairs))
