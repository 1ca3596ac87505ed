"""Particle-particle hard-sphere collisions: cell grid, partner sweep,
impulse exchange, and the pairs rebuild's candidate sweep.

Port of ``argon_monte_carlo_tpu.ops.collide``.  One step of the sweep narrow
phase runs three kernels:

1. ``bin_and_table`` (K2): each particle's cell id, the capacity-padded
   (C+1, cap) table of particle indices (sentinel n), the particle -> slot
   map ``pslot`` and the overflow count;
2. ``partner_sweep`` (K9): each particle's lowest-index partner within the
   collision range over its 27 neighbour cells (-1 = none);
3. ``resolve_pairs`` (K10): mutually matched pairs exchange the elastic
   impulse; completed paths are staged and path accumulators reset, in
   place on the step's own tensors (the rows of the resolved pairs alone),
   and the pair count is added to a counter the caller holds.

The pairs engine's rebuild runs K2 and then ``rebuild_sweep`` (K1): the
one-sided half-shell reach-mode sweep of the active cells, which keeps each
particle's top_k lowest-index candidates and the rebuild-time planes.  The
cube's broad phase is ``allpairs_partner_search`` (K11), the exact
lowest-index search over all N (a z-window's work: the plain version's
z-sorted blocks, the kernel's z-slabs), in place of K2 and K9.

The z-slab engine (``parallel/shard.py``) runs K2, K9 and K10 over a slab's
local and ghost lanes together, with their optional arguments: ``valid``
(K2, K9: a lane that holds no particle), ``ids`` (K9: a particle and its
ghost are two lanes with one id), ``cell_window`` (K9: the slab's own
cells) and ``local_mask`` (K10: ghosts take part in the match, only local
lanes are updated).  Without them each wrapper launches what it always did.

Each wrapper takes the plain PyTorch version (``*_plain``, same signature
and outputs) for tensors on the CPU and launches its CUDA kernel for
tensors on a CUDA device; any other device, or a dtype or layout the
kernel does not take, raises.  The host grid (``Grid``, ``build_grid``,
``grid_for_pore``, ``grid_for_cube``) is numpy and equals the reference's
array for array.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import kernels
from ..state import Measurements, ParticleState
from . import compact, fp
from . import measure as measure_ops

_NO_PARTNER = 1 << 30
# Cells of one run of the cell walk of K9 and K1 (cell_walk.cuh kRunCells).
RUN_CELLS = 8
# The counts a block of the scan of counts that K2 and K11 share takes
# (lookback.cuh kCountTile); a kernel handed fewer look-back words than its
# scan needs launches nothing and fails.
COUNT_SCAN_TILE = 1024
# K11 counts the particles into one z-slab a ALLPAIRS_SLAB_ROWS of them
# (allpairs.cu); its scratch a (device index, stream handle): the slab
# counts (zero between calls), the offsets and the slab-ordered copy.
ALLPAIRS_SLAB_ROWS = 16
_K11_COUNTS: dict = {}
_K11_OFFSETS: dict = {}
_K11_ROWS: dict = {}
# K9's shared memory is 9 * (RUN_CELLS + 2) * 16 + RUN_CELLS * 4 bytes a slot
# of capacity, K1's 5 * (RUN_CELLS + 2) * 20 + RUN_CELLS * 4 * top_k (top_k
# up to 16), of the 227 KB a block can have.
_MAX_WALK_CAPACITY = 128


# --------------------------------------------------------------------------
# Host-side grid construction (collide.py:65-226)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Grid:
    """Compact region-aware uniform grid (host-built, numpy arrays).

    z is divided into ``nz`` uniform layers; layer ``iz`` has an
    ``nx[iz] x nx[iz]`` xy grid centred on the axis.  ``layer_base[iz]`` is
    the flat id of the layer's first cell.  ``neighbors[c, o]`` gives the
    27-neighbourhood cell ids, ``num_cells`` (the dummy empty cell) where a
    neighbour is outside the grid.  ``active_cells`` lists the cells whose
    box meets the gas region; the per-step sweep does not use it (it sweeps
    every row), the pairs rebuild sweeps only those rows.
    """

    cell_size: float
    z_lo: float
    nz: int
    nx: np.ndarray          # (nz,) int32
    layer_base: np.ndarray  # (nz,) int32
    half_extent: np.ndarray  # (nz,) float64
    num_cells: int
    neighbors: np.ndarray   # (num_cells, 27) int32
    capacity: int
    active_cells: np.ndarray | None = None


def _build_neighbors(nz, nx, layer_base) -> np.ndarray:
    num_cells = int(layer_base[-1] + nx[-1] * nx[-1])
    neighbors = np.full((num_cells, 27), num_cells, dtype=np.int32)
    offsets = [(dx, dy, dz)
               for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    for iz in range(nz):
        n = int(nx[iz])
        base = int(layer_base[iz])
        ix, iy = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        ix = ix.ravel()
        iy = iy.ravel()
        cid = base + iy * n + ix
        for o, (dx, dy, dz) in enumerate(offsets):
            jz = iz + dz
            if jz < 0 or jz >= nz:
                continue
            m = int(nx[jz])
            shift = (m - n) // 2
            jx = ix + dx + shift
            jy = iy + dy + shift
            ok = (jx >= 0) & (jx < m) & (jy >= 0) & (jy < m)
            nid = np.where(
                ok, layer_base[jz] + jy * m + jx, num_cells
            ).astype(np.int32)
            neighbors[cid, o] = nid
    return neighbors


def build_grid(cell_size: float, z_lo: float, z_hi: float,
               radius_of_z, capacity: int,
               region_radius_of_z=None) -> Grid:
    """Grid whose per-layer xy extent covers ``radius_of_z(lo, hi)`` plus
    one slack cell all around; ``region_radius_of_z`` (exact gas radius)
    gives the active-cell list."""
    nz = int(np.ceil((z_hi - z_lo) / cell_size))
    nx = np.zeros(nz, dtype=np.int32)
    half_extent = np.zeros(nz, dtype=np.float64)
    for iz in range(nz):
        lo = z_lo + iz * cell_size
        hi = lo + cell_size
        r = radius_of_z(lo, hi)
        half = int(np.ceil(r / cell_size)) + 1  # +1 slack cell
        nx[iz] = 2 * half
        half_extent[iz] = half * cell_size
    layer_base = np.zeros(nz, dtype=np.int64)
    layer_base[1:] = np.cumsum((nx.astype(np.int64) ** 2))[:-1]
    num_cells = int(layer_base[-1] + nx[-1] ** 2)
    neighbors = _build_neighbors(nz, nx, layer_base)
    active = None
    if region_radius_of_z is not None:
        margin = 0.5 * cell_size
        chunks = []
        for iz in range(nz):
            lo = z_lo + iz * cell_size
            hi = lo + cell_size
            r = float(region_radius_of_z(lo - margin, hi + margin))
            nl = int(nx[iz])
            edge = np.arange(nl) * cell_size - half_extent[iz]
            cmin = np.where((edge < 0) & (edge + cell_size > 0), 0.0,
                            np.minimum(np.abs(edge),
                                       np.abs(edge + cell_size)))
            d2 = cmin[:, None] ** 2 + cmin[None, :] ** 2
            iy, ix = np.nonzero(d2 <= (r + margin) ** 2)
            chunks.append(
                (layer_base[iz] + iy * nl + ix).astype(np.int64)
            )
        active = np.sort(np.concatenate(chunks)).astype(np.int32)
    return Grid(
        cell_size=float(cell_size),
        z_lo=float(z_lo),
        nz=nz,
        nx=nx.astype(np.int32),
        layer_base=layer_base.astype(np.int32),
        half_extent=half_extent,
        num_cells=num_cells,
        neighbors=neighbors,
        capacity=int(capacity),
        active_cells=active,
    )


def grid_for_cube(geom, cell_size: float, capacity: int) -> Grid:
    """Uniform grid over the box (collide.py:189-193); binning shifts x and
    y by the box's centre first (``DeviceGrid.center_x/y``), so the grid,
    which is centred on the axis, covers the box.  Every cell is active."""
    r = max(geom.lx, geom.ly) / 2.0
    return build_grid(cell_size, 0.0, geom.lz, lambda lo, hi: r, capacity)


def grid_for_pore(geom, cell_size: float, capacity: int) -> Grid:
    def radius_of_z(lo, hi):
        # Open-air layers (with a one-cell z overlap) use the open-air
        # radius, interior pore layers the gap radius.
        lo -= cell_size
        hi += cell_size
        if lo < geom.open_air_height or hi > geom.cold_top:
            return geom.open_air_radius
        return geom.gap_radius

    def region_radius_of_z(lo, hi):
        segs = (
            (0.0, geom.open_air_height, geom.open_air_radius),
            (geom.open_air_height, geom.gap_bottom,
             geom.pore_coated_radius),
            (geom.gap_bottom, geom.gap_top, geom.gap_radius),
            (geom.gap_top, geom.cold_top, geom.pore_coated_radius),
            (geom.cold_top, geom.total_height, geom.open_air_radius),
        )
        r = 0.0
        for a, b, rr in segs:
            if hi > a and lo < b:
                r = max(r, rr)
        return r

    return build_grid(cell_size, 0.0, geom.total_height, radius_of_z,
                      capacity, region_radius_of_z=region_radius_of_z)


def cell_runs(nx, layer_base, run_cells: int = RUN_CELLS) -> np.ndarray:
    """(R + 1,) int32 run starts of K9's cell walk: the cell ids 0..C cut
    into runs [start[r], start[r + 1]) of at most ``run_cells`` consecutive
    cells that never leave one x-row of one layer (cell ids run x-fastest,
    ``base + iy * n + ix``).  An x-row of n cells is cut into
    ceil(n / run_cells) runs of nearly equal length."""
    nx = np.asarray(nx, dtype=np.int64)
    starts = []
    for n, base in zip(nx, np.asarray(layer_base, dtype=np.int64)):
        pieces = -(-n // run_cells)
        cuts = (np.arange(pieces) * n) // pieces
        starts.append((base + n * np.arange(n)[:, None] + cuts[None, :])
                      .ravel())
    num_cells = int(layer_base[-1]) + int(nx[-1]) ** 2
    return np.concatenate(starts + [[num_cells]]).astype(np.int32)


def run_rows(neighbors: np.ndarray, run_start: np.ndarray,
             run_cells: int = RUN_CELLS) -> np.ndarray:
    """(R, 9, run_cells + 2) the table rows K9's cell walk stages for each
    run and each (dz, dy) group g, the kernel's arithmetic on the host
    (cell_walk.cuh): column 3g of the run's first cell, column 3g + 1 of
    every cell, column 3g + 2 of its last; ``num_cells`` (the empty dummy
    row) beyond a short run.  Cell k of the run then finds its columns 3g,
    3g + 1, 3g + 2 at rows k, k + 1, k + 2 of group g."""
    num_cells = neighbors.shape[0]
    c0 = run_start[:-1].astype(np.int64)
    length = run_start[1:].astype(np.int64) - c0
    grouped = neighbors.reshape(num_cells, 9, 3)
    rows = np.full((c0.shape[0], 9, run_cells + 2), num_cells, np.int32)
    rows[:, :, 0] = grouped[c0, :, 0]
    for k in range(run_cells):
        has = length > k
        rows[has, :, k + 1] = grouped[c0[has] + k, :, 1]
    runs = np.arange(c0.shape[0])
    rows[runs, :, length + 1] = grouped[c0 + length - 1, :, 2]
    return rows


def half_shell_rows(neighbors: np.ndarray, run_start: np.ndarray,
                    run_cells: int = RUN_CELLS) -> np.ndarray:
    """(R, 5, run_cells + 2) the table rows K1's walk stages: groups 4 to 8
    of ``run_rows``, without row 0 of group 4 (neighbour column 12, which
    the half shell, columns 13-26, leaves out; the kernel stages the empty
    dummy row there).  Cell k of the run finds columns 13 and 14 at rows
    k + 1 and k + 2 of the first group, and columns 15-26 at rows k, k + 1,
    k + 2 of the other four."""
    rows = run_rows(neighbors, run_start, run_cells)[:, 4:].copy()
    rows[:, 0, 0] = neighbors.shape[0]
    return rows


@dataclasses.dataclass(frozen=True)
class DeviceGrid:
    """Grid tables on the device: int32 nx, layer_base and neighbors, the
    working-dtype half_extent, the scalars the kernels take,
    ``active_rank`` -- each cell's rank in the active-cell list, -1 for an
    inactive cell and for the dummy cell (reference DeviceGrid.active_rank,
    collide.py:245-250; every cell is active when the host grid has no
    list) -- ``run_start``, the runs of K9's cell walk (``cell_runs``),
    and the xy offset binning subtracts first (``center_x``, ``center_y``:
    the box's centre for the cube, 0 for the pores; reference
    collide.py:243-244)."""

    nx: torch.Tensor           # (nz,) int32
    layer_base: torch.Tensor   # (nz,) int32
    half_extent: torch.Tensor  # (nz,) dtype
    neighbors: torch.Tensor    # (num_cells, 27) int32
    cell_size: float
    z_lo: float
    nz: int
    num_cells: int
    capacity: int
    active_rank: torch.Tensor  # (num_cells + 1,) int32
    run_start: torch.Tensor    # (runs + 1,) int32
    center_x: float = 0.0
    center_y: float = 0.0

    @staticmethod
    def from_grid(grid: Grid, dtype, device,
                  center_xy=(0.0, 0.0)) -> "DeviceGrid":
        def put(a, dt):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                   device=device)

        return DeviceGrid(
            nx=put(grid.nx, torch.int32),
            layer_base=put(grid.layer_base, torch.int32),
            half_extent=put(grid.half_extent, dtype),
            neighbors=put(grid.neighbors, torch.int32),
            cell_size=grid.cell_size,
            z_lo=grid.z_lo,
            nz=grid.nz,
            num_cells=grid.num_cells,
            capacity=grid.capacity,
            active_rank=put(active_rank_for(grid.num_cells,
                                            grid.active_cells), torch.int32),
            run_start=put(cell_runs(grid.nx, grid.layer_base), torch.int32),
            center_x=float(center_xy[0]),
            center_y=float(center_xy[1]),
        )


def active_rank_for(num_cells: int, active_cells) -> np.ndarray:
    """(num_cells + 1,) rank of each cell in the active list, -1 if
    inactive (the dummy cell always is); all cells when the list is None."""
    rank = np.full(num_cells + 1, -1, np.int32)
    if active_cells is None:
        active_cells = np.arange(num_cells)
    rank[np.asarray(active_cells)] = np.arange(len(active_cells),
                                               dtype=np.int32)
    return rank


# --------------------------------------------------------------------------
# K2: cell binning and cell table (collide.py:317-391)
# --------------------------------------------------------------------------


def assign_cells_plain(pos: torch.Tensor, grid: DeviceGrid) -> torch.Tensor:
    """(N,) int32 flat cell id per particle (strays clamp into edge
    cells), collide.py:324-349: x and y less the grid's centre first (a
    float32 subtraction of 0 changes no bit, so the pores' ids are the
    same as without it)."""
    x = pos[:, 0] - grid.center_x
    y = pos[:, 1] - grid.center_y
    z = pos[:, 2]
    iz = torch.clamp(
        torch.floor(fp.div(z - grid.z_lo, grid.cell_size)).to(torch.int32),
        0, grid.nz - 1,
    ).long()
    nx = grid.nx[iz]
    half = grid.half_extent[iz]
    ix = torch.minimum(torch.clamp(
        torch.floor(fp.div(x + half, grid.cell_size)).to(torch.int32), min=0),
        nx - 1)
    iy = torch.minimum(torch.clamp(
        torch.floor(fp.div(y + half, grid.cell_size)).to(torch.int32), min=0),
        nx - 1)
    return grid.layer_base[iz] + iy * nx + ix


def bin_and_table_plain(pos: torch.Tensor, grid: DeviceGrid,
                        valid: torch.Tensor | None = None):
    """Plain version of K2: (cell_id (N,), table (C+1, cap), pslot (N,),
    overflow ()) -- all int32, equal to the reference's assign_cells +
    build_cell_table.  The stable sort decides which particles keep a
    slot in a full cell: the lowest indices do.

    A lane with ``valid`` False (a slab's padding, collide.py:350-351, 374)
    goes to the dummy cell ``num_cells``: it takes no slot (its pslot is
    the dummy slot ``num_cells * cap``; the reference leaves dummy-row
    ranks there, which read the same) and is no overflow."""
    n = pos.shape[0]
    cap = grid.capacity
    num_cells = grid.num_cells
    dev = pos.device
    cell_id = assign_cells_plain(pos, grid)
    if valid is not None:
        cell_id = torch.where(valid, cell_id, num_cells)
    sorted_cid, order = torch.sort(cell_id, stable=True)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    is_start[1:] = sorted_cid[1:] != sorted_cid[:-1]
    first = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    rank = idx - first
    real = sorted_cid < num_cells
    in_cap = (rank < cap) & real
    overflow = torch.sum(~in_cap & real, dtype=torch.int32)
    slot = torch.where(in_cap, sorted_cid.long() * cap + rank,
                       num_cells * cap)
    # Out-of-capacity ranks are masked here; the reference writes them
    # into the dummy row with mode="drop" and wipes it.
    table = torch.full(((num_cells + 1) * cap,), n, dtype=torch.int32,
                       device=dev)
    table[slot[in_cap]] = order[in_cap].to(torch.int32)
    pslot = torch.empty(n, dtype=torch.int32, device=dev)
    pslot[order] = slot.to(torch.int32)
    return cell_id, table.view(num_cells + 1, cap), pslot, overflow


# The largest cell capacity K2's kernel takes (bin_and_table.cu kMaxCap).
K2_MAX_CAPACITY = 128
# (device index, stream handle) -> K2's scratch: counts, zero between
# calls (the kernel leaves it so); offsets and seg, no invariant.
_k2_counts: dict = {}
_k2_work: dict = {}


def _round4(k: int) -> int:
    return -(-k // 4) * 4


def bin_and_table(pos: torch.Tensor, grid: DeviceGrid,
                  valid: torch.Tensor | None = None):
    """K2 (see ``bin_and_table_plain``); CUDA kernel for CUDA tensors: a
    counting sort in four launches (bin, a single-pass scan, scatter, a
    warp-cooperative table fill), allocating nothing but its four outputs.
    Its scratch is kept for each device and stream and grown on demand
    (``compact.stream_scratch``), so calls on a stream and a launch
    recorded in a CUDA graph (after one call on the capturing stream) are
    both right."""
    if kernels.use_plain(pos):
        return bin_and_table_plain(pos, grid, valid)
    dev = pos.device
    n = pos.shape[0]
    cap = grid.capacity
    num_cells = grid.num_cells
    kernels.check(pos, "pos", torch.float32, (n, 3), dev)
    if valid is not None:
        kernels.check(valid, "valid", torch.bool, (n,), dev)
    kernels.check(grid.nx, "grid.nx", torch.int32, (grid.nz,), dev)
    kernels.check(grid.layer_base, "grid.layer_base", torch.int32,
                  (grid.nz,), dev)
    kernels.check(grid.half_extent, "grid.half_extent", torch.float32,
                  (grid.nz,), dev)
    if not 1 <= cap <= K2_MAX_CAPACITY:
        raise ValueError(f"cell capacity {cap}: the kernel takes 1 to "
                         f"{K2_MAX_CAPACITY}")

    def i32(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    cell_id, pslot = i32(n), i32(n)
    table = i32(num_cells + 1, cap)
    overflow = i32()
    counts = compact.stream_scratch(_k2_counts, dev, num_cells, torch.int32,
                                    0)
    # offsets (num_cells + 1) then seg (n), each on a 16-byte boundary.
    seg_at = _round4(num_cells + 1)
    work = compact.stream_scratch(_k2_work, dev, seg_at + n, torch.int32, 0)
    scan = compact.lookback_scratch(dev, -(-num_cells // COUNT_SCAN_TILE))
    p = kernels.ptr
    kernels.launch(
        "bin_and_table", dev, p(pos), kernels.optional_ptr(valid), n,
        p(grid.nx), p(grid.layer_base),
        p(grid.half_extent), grid.nz, grid.z_lo, grid.cell_size,
        grid.center_x, grid.center_y, num_cells,
        cap, p(cell_id), p(table), p(pslot), p(overflow), p(counts),
        p(work), p(work[seg_at:]), p(scan), scan.shape[0],
    )
    return cell_id, table, pslot, overflow


# --------------------------------------------------------------------------
# K9: per-step partner sweep (collide.py:423-961, radius mode, top_k=1)
# --------------------------------------------------------------------------


def partner_sweep_plain(pos: torch.Tensor, table: torch.Tensor,
                        pslot: torch.Tensor, grid: DeviceGrid,
                        search_radius: float,
                        chunk: int = 1 << 15,
                        ids: torch.Tensor | None = None,
                        valid: torch.Tensor | None = None,
                        cell_window: tuple | None = None) -> torch.Tensor:
    """Plain version of K9: (N,) int32 lowest-index j != i in the 27
    neighbour cells of i's own row with d^2 < r^2, -1 for none.

    Works through the particles in chunks so the (chunk, 27*cap) candidate
    block stays small.  d^2 is formed as (dx*dx + dy*dy) + dz*dz with
    dx = x_i - x_j, the reference's order.

    The z-slab engine's arguments (collide.py:433-442): ``ids`` (N,) int32
    replaces the index in the self-exclusion (a candidate with the
    particle's own id is skipped; the partner is still the lowest lane
    index); a lane with ``valid`` False gets -1; ``cell_window`` =
    (start, width) gives -1 to a particle whose own cell lies outside
    [start, start + width) (its neighbour cells are read wherever they
    lie).
    """
    n = pos.shape[0]
    cap = grid.capacity
    dummy = grid.num_cells * cap
    r2 = search_radius * search_radius
    # A far row at index n stands in for the sentinel slots.
    pos_pad = torch.cat([pos, torch.full((1, 3), 1e9, dtype=pos.dtype,
                                         device=pos.device)])
    index = torch.arange(n, dtype=torch.int32, device=pos.device)
    ids_pad = torch.cat([index if ids is None else ids,
                         torch.full((1,), -2, dtype=torch.int32,
                                    device=pos.device)])
    out = torch.empty(n, dtype=torch.int32, device=pos.device)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        s = pslot[lo:hi].long()
        listed = s < dummy
        if valid is not None:
            listed = listed & valid[lo:hi]
        if cell_window is not None:
            start, width = cell_window
            listed = listed & (s // cap >= start) & (s // cap < start + width)
        cell = torch.where(listed, s // cap, 0)
        cand = table[grid.neighbors[cell].long()].reshape(hi - lo, 27 * cap)
        cl = cand.long()
        d = pos[lo:hi, None, :] - pos_pad[cl]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
        d2 = d2 + d[..., 2] * d[..., 2]
        hit = (d2 < r2) & (cand < n) & (ids_pad[cl] != ids_pad[lo:hi, None])
        best = torch.where(hit, cand, _NO_PARTNER).amin(dim=1)
        best = torch.where(listed & (best < _NO_PARTNER), best, -1)
        out[lo:hi] = best.to(torch.int32)
    return out


def partner_sweep(pos: torch.Tensor, table: torch.Tensor,
                  pslot: torch.Tensor, grid: DeviceGrid,
                  search_radius: float,
                  ids: torch.Tensor | None = None,
                  valid: torch.Tensor | None = None,
                  cell_window: tuple | None = None) -> torch.Tensor:
    """K9 (see ``partner_sweep_plain``); CUDA kernel for CUDA tensors.
    The kernel walks the table by cells (``grid.run_start``), not the
    particles by index: ``table`` and ``pslot`` must come from
    ``bin_and_table`` on this grid, so that a particle with a slot is
    listed in its cell's row, rows are filled from the front and the dummy
    row is empty.  ``pslot`` itself is then not read."""
    if kernels.use_plain(pos):
        return partner_sweep_plain(pos, table, pslot, grid, search_radius,
                                   ids=ids, valid=valid,
                                   cell_window=cell_window)
    dev = pos.device
    n = pos.shape[0]
    cap = grid.capacity
    if cap > _MAX_WALK_CAPACITY:
        raise ValueError(f"cell capacity {cap}: the kernel stages a run's "
                         f"neighbourhood in shared memory, which holds "
                         f"capacities up to {_MAX_WALK_CAPACITY}")
    if ids is not None:
        kernels.check(ids, "ids", torch.int32, (n,), dev)
    if valid is not None:
        kernels.check(valid, "valid", torch.bool, (n,), dev)
    start, width = (0, grid.num_cells) if cell_window is None else (
        int(cell_window[0]), int(cell_window[1]))
    runs = grid.run_start.shape[0] - 1
    kernels.check(pos, "pos", torch.float32, (n, 3), dev)
    kernels.check(table, "table", torch.int32, (grid.num_cells + 1, cap), dev)
    kernels.check(pslot, "pslot", torch.int32, (n,), dev)
    kernels.check(grid.neighbors, "grid.neighbors", torch.int32,
                  (grid.num_cells, 27), dev)
    kernels.check(grid.run_start, "grid.run_start", torch.int32, (runs + 1,),
                  dev)
    partner = torch.empty(n, dtype=torch.int32, device=dev)
    p = kernels.ptr
    kernels.launch(
        "partner_sweep", dev, p(pos), p(table), p(grid.neighbors),
        p(grid.run_start), kernels.optional_ptr(ids),
        kernels.optional_ptr(valid), n, grid.num_cells, cap, runs, RUN_CELLS,
        start, width, search_radius * search_radius, p(partner),
    )
    return partner


# --------------------------------------------------------------------------
# K11: the all-pairs partner search (collide.py:1001-1034)
# --------------------------------------------------------------------------


def allpairs_partner_search_plain(pos: torch.Tensor, search_radius: float,
                                  tile: int = 2048) -> torch.Tensor:
    """Plain version of K11: (N,) int32 lowest index j != i over all N with
    d^2 < r^2, -1 for none -- the reference's masked minimum over j, with
    d^2 = (dx*dx + dy*dy) + dz*dz and dx = x_i - x_j, each operation
    rounded once.

    Rows go in blocks of at most min(tile, 256) in z order, and each block
    meets only the j whose z lies within ``reach`` of its own z range: any
    other j has |z_i - z_j| > r for every row of the block, so |fl(dz)| >= r
    and, rounding being monotone, d^2 >= r^2 -- no hit.  ``reach`` is r
    plus a margin for the rounding of the window's bounds.  The answer
    equals the reference's tiled scan over all N exactly, at a fraction of
    the work."""
    n = pos.shape[0]
    dev = pos.device
    r2 = search_radius * search_radius
    order = torch.argsort(pos[:, 2], stable=True)
    axes = pos[order].t().contiguous()      # (3, N) in z order
    ids = order.to(torch.int32)             # each sorted row's index
    z = axes[2]
    partner = torch.full((n,), -1, dtype=torch.int32, device=dev)
    if n == 0:
        return partner
    z_max = max(abs(float(z[0])), abs(float(z[-1])))
    reach = (search_radius * (1.0 + 1e-3)
             + 4.0 * torch.finfo(pos.dtype).eps * z_max)
    rows = max(1, min(tile, 256))
    starts = torch.arange(0, n, rows, device=dev)
    ends = torch.clamp(starts + rows, max=n)
    lo = torch.searchsorted(z, z[starts] - reach)
    hi = torch.searchsorted(z, z[ends - 1] + reach, right=True)
    best = torch.empty(n, dtype=torch.int32, device=dev)
    for s, e, a, b in zip(starts.tolist(), ends.tolist(), lo.tolist(),
                          hi.tolist()):
        cand = ids[None, a:b]
        dx, dy, dz = axes[:, s:e, None] - axes[:, None, a:b]
        d2 = dx.mul_(dx).add_(dy.mul_(dy)).add_(dz.mul_(dz))
        hit = (d2 < r2) & (ids[s:e, None] != cand)
        best[s:e] = torch.where(hit, cand, _NO_PARTNER).amin(dim=1)
    partner[order] = torch.where(best < _NO_PARTNER, best, -1).to(torch.int32)
    return partner


def allpairs_slabs(n: int) -> int:
    """The z-slabs K11 counts ``n`` particles into: one a
    ``ALLPAIRS_SLAB_ROWS`` particles, at least 3 (allpairs.cu)."""
    return max(3, -(-n // ALLPAIRS_SLAB_ROWS))


def allpairs_partner_search(pos: torch.Tensor, search_radius: float,
                            tile: int = 2048) -> torch.Tensor:
    """K11 (see ``allpairs_partner_search_plain``); CUDA kernel for CUDA
    tensors: four launches, a counting sort of the particles by z-slab and
    a search of each particle's own and two neighbouring slabs (``tile``
    bounds only the plain version's blocks).  Its scratch (slab counts and
    offsets, the slab-ordered copy, the look-back words) is kept for each
    stream of each device, restored by the kernel, and grown, never freed,
    for a larger N (see ``ops/compact.stream_scratch``); make one call on a
    stream before recording one in a CUDA graph there."""
    if kernels.use_plain(pos):
        return allpairs_partner_search_plain(pos, search_radius, tile)
    dev = pos.device
    n = pos.shape[0]
    kernels.check(pos, "pos", torch.float32, (n, 3), dev)
    slabs = allpairs_slabs(n)
    i32 = torch.int32
    counts = compact.stream_scratch(_K11_COUNTS, dev, slabs, i32, 0)
    offsets = compact.stream_scratch(_K11_OFFSETS, dev, slabs + 1, i32, 0)
    rows = compact.stream_scratch(_K11_ROWS, dev, 4 * n, i32, 0)
    scan = compact.lookback_scratch(dev, -(-slabs // COUNT_SCAN_TILE))
    partner = torch.empty(n, dtype=i32, device=dev)
    p = kernels.ptr
    kernels.launch("allpairs_partner", dev, p(pos), n,
                   search_radius * search_radius, slabs, p(counts),
                   p(offsets), p(rows), p(scan), scan.shape[0], p(partner))
    return partner


# --------------------------------------------------------------------------
# K1: the pairs rebuild's candidate sweep (collide.py:453-961, reach mode,
# one-sided, half shell, active rows)
# --------------------------------------------------------------------------

_HALF_SHELL = slice(13, 27)


def rebuild_planes_plain(pos: torch.Tensor, reach: torch.Tensor,
                         table: torch.Tensor):
    """The rebuild-time slot planes: pos0 (rows, cap, 3) and reach0
    (rows, cap) gathered through the K2 table; empty slots hold the
    reference's far position 1e9 and reach 0 (collide.py:540-576)."""
    n = pos.shape[0]
    real = table < n
    src = torch.where(real, table, 0).long()
    pos0 = torch.where(real[..., None], pos[src],
                       torch.full((), 1e9, dtype=pos.dtype,
                                  device=pos.device))
    reach0 = torch.where(real, reach[src], torch.zeros((), dtype=reach.dtype,
                                                       device=pos.device))
    return pos0, reach0


def rebuild_sweep_plain(pos: torch.Tensor, reach: torch.Tensor,
                        table: torch.Tensor, pslot: torch.Tensor,
                        grid: DeviceGrid, top_k: int,
                        chunk: int = 1 << 14):
    """Plain version of K1.  Returns (cands (N, top_k) int32 ascending,
    -1 padded; unswept (N,) bool; pos0; reach0).

    Particle i (the emitter) in an active cell scans neighbour columns
    13-26 of its own cell (the half shell); in its own cell (column 13)
    only higher indices count.  A hit is d^2 < (reach_i + reach_j)^2 with
    d^2 = (dx*dx + dy*dy) + dz*dz, dx = x_i - x_j.  A particle without a
    slot emits nothing; one in an inactive cell emits nothing and is
    unswept.  Works through the particles in chunks so the (chunk, 14*cap)
    candidate block stays small.
    """
    n = pos.shape[0]
    cap = grid.capacity
    dummy = grid.num_cells * cap
    dev = pos.device
    pos0, reach0 = rebuild_planes_plain(pos, reach, table)
    cands = torch.full((n, top_k), -1, dtype=torch.int32, device=dev)
    unswept = torch.zeros(n, dtype=torch.bool, device=dev)
    big = torch.full((), _NO_PARTNER, dtype=torch.int32, device=dev)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        s = pslot[lo:hi].long()
        listed = s < dummy
        cell = torch.where(listed, s // cap, grid.num_cells)
        covered = listed & (grid.active_rank[cell] >= 0)
        unswept[lo:hi] = listed & ~covered
        rows = grid.neighbors[torch.where(covered, cell, 0)][:, _HALF_SHELL]
        rows = rows.long()
        idx = table[rows].reshape(hi - lo, -1)
        d = pos[lo:hi, None, :] - pos0[rows].reshape(hi - lo, -1, 3)
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
        d2 = d2 + d[..., 2] * d[..., 2]
        th = reach[lo:hi, None] + reach0[rows].reshape(hi - lo, -1)
        own = torch.arange(lo, hi, dtype=torch.int32, device=dev)[:, None]
        lanes = torch.arange(idx.shape[1], device=dev)[None, :]
        id_ok = (lanes >= cap) | (idx > own)
        hit = (d2 < th * th) & (idx < n) & id_ok & covered[:, None]
        masked = torch.where(hit, idx, big)
        k = min(top_k, masked.shape[1])
        best = torch.sort(masked, dim=1).values[:, :k]
        cands[lo:hi, :k] = torch.where(best < _NO_PARTNER, best, -1)
    return cands, unswept, pos0, reach0


def rebuild_sweep(pos: torch.Tensor, reach: torch.Tensor,
                  table: torch.Tensor, pslot: torch.Tensor,
                  grid: DeviceGrid, top_k: int):
    """K1 (see ``rebuild_sweep_plain``); CUDA kernel for CUDA tensors.
    The kernel walks the table by cells (``grid.run_start``), as K9 does:
    ``table`` and ``pslot`` must come from ``bin_and_table`` on this grid,
    so that a particle with a slot is listed in its cell's row, rows are
    ascending and filled from the front, and the dummy row is empty."""
    if kernels.use_plain(pos):
        return rebuild_sweep_plain(pos, reach, table, pslot, grid, top_k)
    dev = pos.device
    n = pos.shape[0]
    cap = grid.capacity
    rows = grid.num_cells + 1
    if not 1 <= top_k <= 16:
        raise ValueError(f"top_k={top_k}: the kernel keeps 1 to 16")
    if cap > _MAX_WALK_CAPACITY:
        raise ValueError(f"cell capacity {cap}: the kernel stages a run's "
                         f"half shell in shared memory, which holds "
                         f"capacities up to {_MAX_WALK_CAPACITY}")
    runs = grid.run_start.shape[0] - 1
    f32, i32 = torch.float32, torch.int32
    kernels.check(pos, "pos", f32, (n, 3), dev)
    kernels.check(reach, "reach", f32, (n,), dev)
    kernels.check(table, "table", i32, (rows, cap), dev)
    kernels.check(pslot, "pslot", i32, (n,), dev)
    kernels.check(grid.neighbors, "grid.neighbors", i32,
                  (grid.num_cells, 27), dev)
    kernels.check(grid.active_rank, "grid.active_rank", i32, (rows,), dev)
    kernels.check(grid.run_start, "grid.run_start", i32, (runs + 1,), dev)
    pos0 = torch.empty((rows, cap, 3), dtype=f32, device=dev)
    reach0 = torch.empty((rows, cap), dtype=f32, device=dev)
    cands = torch.empty((n, top_k), dtype=i32, device=dev)
    unswept = torch.empty(n, dtype=torch.bool, device=dev)
    p = kernels.ptr
    kernels.launch(
        "rebuild_sweep", dev, p(pos), p(reach), p(table), p(pslot),
        p(grid.neighbors), p(grid.active_rank), p(grid.run_start), n,
        grid.num_cells, cap, top_k, runs, RUN_CELLS, p(pos0), p(reach0),
        p(cands), p(unswept),
    )
    return cands, unswept, pos0, reach0


# --------------------------------------------------------------------------
# K10: impulse exchange (collide.py:1042-1142)
# --------------------------------------------------------------------------


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row dot product summed (x + y) + z, the reference's order."""
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def resolve_pairs_plain(state: ParticleState, measure: Measurements,
                        partner: torch.Tensor, collision_range: float,
                        count: torch.Tensor | None = None,
                        local_mask: torch.Tensor | None = None):
    """Plain version of K10.  Returns (state, measure, count); ``state``'s
    four tensors, ``measure``'s ``pending_vals`` and ``pending_mask`` and
    ``count`` are updated in place and returned, as the kernel does, and
    only the rows of the lanes applied to are written.

    A pair (a, b) is resolved iff partner[a] == b and partner[b] == a and
    they overlap and approach: t is the larger root of
    |dx - dv t|^2 = cr^2; both rewind by t, exchange the impulse along the
    contact normal and replay.  Completed paths are staged with the
    pre-collision velocity (record_completed) and path accumulators reset
    to the residual along the new direction (end_paths).  ``count`` (an
    int32 () tensor, or None to count nothing) grows by the pairs
    resolved.

    With ``local_mask`` (the z-slab engine, collide.py:1067-1071): a lane
    holding a neighbour's ghost takes part in the match, but state,
    staging and path resets apply only where ``ok & local_mask``; ``count``
    then grows by sum(apply), not by the pairs (the caller counts each pair
    on the slab that owns the lower id), and the matched mask ``ok`` is
    returned fourth: (state, measure, count, ok (N,)).
    """
    n = state.pos.shape[0]
    pos, vel = state.pos, state.vel
    idx = torch.arange(n, dtype=torch.int32, device=pos.device)
    has_partner = partner >= 0
    sp = torch.where(has_partner, partner, 0).long()
    mutual = has_partner & (partner[sp] == idx)
    pos_b, vel_b = pos[sp], vel[sp]
    dxv = pos_b - pos
    dvv = vel - vel_b

    a = _dot3(dvv, dvv)
    b = 2.0 * _dot3(dxv, dvv)
    c = _dot3(dxv, dxv) - collision_range * collision_range
    disc = b * b - 4.0 * a * c
    ok = mutual & (a > 0.0) & (disc >= 0.0) & (c < 0.0)
    sq = fp.sqrt(torch.clamp(disc, min=0.0))
    a_safe = torch.where(a == 0.0, torch.ones_like(a), a)
    t = torch.maximum((-b + sq) / (2.0 * a_safe), (-b - sq) / (2.0 * a_safe))

    qa = pos - vel * t[:, None]
    qb = pos_b - vel_b * t[:, None]
    normal = fp.div(qb - qa, collision_range)
    p_scal = _dot3(dvv, normal)
    new_vel = vel - p_scal[:, None] * normal
    new_pos = qa + new_vel * t[:, None]

    apply = ok if local_mask is None else ok & local_mask
    staged = measure_ops.record_completed(
        measure, state.paths, state.has_collided, vel, t, apply)
    ended = measure_ops.end_paths(state, apply, t, new_vel,
                                  zero_residual=False)
    # In place, once everything is computed from the inputs: the rows of
    # the lanes applied to, and nothing else.
    rows = torch.nonzero(apply).flatten()
    pos[rows] = new_pos[rows]
    vel[rows] = new_vel[rows]
    state.paths[rows] = ended.paths[rows]
    state.has_collided[rows] = True
    measure.pending_vals[rows] = staged.pending_vals[rows]
    measure.pending_mask[rows] = staged.pending_mask[rows]
    if count is not None:
        count.add_(torch.sum(ok, dtype=torch.int32) // 2
                   if local_mask is None
                   else torch.sum(apply, dtype=torch.int32))
    if local_mask is None:
        return state, measure, count
    return state, measure, count, ok


def resolve_pairs(state: ParticleState, measure: Measurements,
                  partner: torch.Tensor, collision_range: float,
                  count: torch.Tensor | None = None,
                  local_mask: torch.Tensor | None = None):
    """K10 (see ``resolve_pairs_plain``); CUDA kernel for CUDA tensors: one
    launch, in place like the twin, touching only the rows of matched
    pairs.  Returns (state, measure, count) -- with ``local_mask``,
    (state, measure, count, ok (N,)) -- and leaves ``collision_count`` to
    the caller, as the plain version does.  No allocation but ``ok``, no
    scratch: a launch replays in a CUDA graph."""
    pos = state.pos
    if kernels.use_plain(pos):
        return resolve_pairs_plain(state, measure, partner, collision_range,
                                   count, local_mask)
    dev = pos.device
    n = pos.shape[0]
    f32, b8 = torch.float32, torch.bool
    inputs = [
        (pos, "pos", f32, (n, 3)), (state.vel, "vel", f32, (n, 3)),
        (state.paths, "paths", f32, (n, 4)),
        (state.has_collided, "has_collided", b8, (n,)),
        (partner, "partner", torch.int32, (n,)),
        (measure.pending_vals, "pending_vals", f32, (n, 4)),
        (measure.pending_mask, "pending_mask", b8, (n,)),
    ]
    for t, name, dt, shape in inputs:
        kernels.check(t, name, dt, shape, dev)
    if count is not None:
        kernels.check(count, "count", torch.int32, (), dev)
    ok = None
    if local_mask is not None:
        kernels.check(local_mask, "local_mask", b8, (n,), dev)
        ok = torch.empty(n, dtype=b8, device=dev)
    p = kernels.ptr
    cr = collision_range
    kernels.launch(
        "resolve_pairs", dev, *(p(t) for t, *_ in inputs),
        kernels.optional_ptr(local_mask), n, cr, cr * cr,
        kernels.optional_ptr(ok), kernels.optional_ptr(count),
    )
    if local_mask is None:
        return state, measure, count
    return state, measure, count, ok
