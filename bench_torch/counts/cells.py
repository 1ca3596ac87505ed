"""Pair tests a cell grid needs on a set of positions (copied from
``chip_smoke.neighbor_slots`` and ``chip_smoke.allpairs_cell_tests``), and
the pairs whose spheres of reach overlap."""

from __future__ import annotations

import math

import numpy as np
import torch


def cell_side(r: float) -> float:
    """The side of the finest cell grid whose 27 cells around a particle
    hold every particle within r of it: 1.001 sqrt(r2), r2 the float32
    r^2 (K11's z-slab width)."""
    return math.sqrt(float(np.float32(r * r))) * 1.001


def grid_tests(pos: torch.Tensor, side: float) -> int:
    """Sum over the particles of the particles in the 27 cells of side
    ``side`` around each one's own (itself included): the pair tests a
    sweep of a cell grid of that side makes on this data."""
    ijk = torch.floor(pos.double() / side).long()
    ijk -= ijk.min(dim=0).values - 1
    span = int(ijk.max()) + 2
    keys, counts = torch.unique((ijk[:, 0] * span + ijk[:, 1]) * span
                                + ijk[:, 2], return_counts=True)
    near = torch.zeros_like(counts)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                other = keys + (dx * span + dy) * span + dz
                at = torch.searchsorted(keys, other).clamp(max=len(keys) - 1)
                near += torch.where(keys[at] == other, counts[at], 0)
    return int((counts * near).sum())


def neighbor_slots(table, pslot, grid, n, cols=slice(0, 27)) -> int:
    """Occupied slots in the listed particles' neighbour rows ``cols`` of
    a binned table: the pair tests a sweep over those rows needs."""
    occ = (table < n).sum(dim=1)
    cap = grid.capacity
    listed = pslot < grid.num_cells * cap
    cell = (pslot[listed] // cap).long()
    return int(occ[grid.neighbors[cell][:, cols].long()].sum())


def pairs_within(pos: torch.Tensor, reach: torch.Tensor,
                 block: int = 1 << 22) -> int:
    """Unordered pairs i < j with d^2 < (reach_i + reach_j)^2, d^2 =
    (dx*dx + dy*dy) + dz*dz in the positions' precision: what a Verlet
    rebuild has to find, whatever its grid.  A cell list of side twice the
    largest reach, each particle against the particles of its 27 cells,
    ``block`` candidates at a time."""
    n, dev = pos.shape[0], pos.device
    if n < 2:
        return 0
    side = 2.0 * float(reach.max())
    p64 = pos.double()
    ijk = torch.floor((p64 - p64.amin(dim=0)) / side).long() + 1
    dims = ijk.amax(dim=0) + 2
    key = (ijk[:, 0] * dims[1] + ijk[:, 1]) * dims[2] + ijk[:, 2]
    order = torch.argsort(key)
    cells, counts = torch.unique_consecutive(key[order], return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    cap = int(counts.max())
    table = torch.full((cells.shape[0] + 1, cap), n, dtype=torch.int64,
                       device=dev)
    table[torch.arange(cells.shape[0], device=dev).repeat_interleave(counts),
          torch.arange(n, device=dev) - starts.repeat_interleave(counts)] = \
        order
    pos_pad = torch.cat([pos, pos.new_zeros((1, 3))])
    reach_pad = torch.cat([reach, reach.new_zeros((1,))])
    offsets = torch.tensor([(a * dims[1] + b) * dims[2] + c
                            for a in (-1, 0, 1) for b in (-1, 0, 1)
                            for c in (-1, 0, 1)], device=dev)
    total = 0
    chunk = max(1, block // (27 * cap))
    for lo in range(0, n, chunk):
        i = torch.arange(lo, min(lo + chunk, n), device=dev)
        nb = key[i, None] + offsets[None, :]
        at = torch.searchsorted(cells, nb).clamp(max=cells.shape[0] - 1)
        row = torch.where(cells[at] == nb, at, cells.shape[0])
        cand = table[row].reshape(i.shape[0], -1)
        d = pos[i, None, :] - pos_pad[cand]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
        d2 = d2 + d[..., 2] * d[..., 2]
        th = reach[i, None] + reach_pad[cand]
        total += int(((d2 < th * th) & (cand > i[:, None])
                      & (cand < n)).sum())
    return total
