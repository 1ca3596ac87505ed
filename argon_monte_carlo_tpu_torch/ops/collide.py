"""Particle-particle hard-sphere collisions: cell grid, partner sweep,
impulse exchange.

Port of ``argon_monte_carlo_tpu.ops.collide`` for the per-step sweep narrow
phase.  One step runs three kernels:

1. ``bin_and_table`` (K2): each particle's cell id, the capacity-padded
   (C+1, cap) table of particle indices (sentinel n), the particle -> slot
   map ``pslot`` and the overflow count;
2. ``partner_sweep`` (K9): each particle's lowest-index partner within the
   collision range over its 27 neighbour cells (-1 = none);
3. ``resolve_pairs`` (K10): mutually matched pairs exchange the elastic
   impulse; completed paths are staged and path accumulators reset.

Each wrapper takes the plain PyTorch version (``*_plain``, same signature
and outputs) for tensors on the CPU and launches its CUDA kernel for
tensors on a CUDA device; any other device, or a dtype or layout the
kernel does not take, raises.  The host grid (``Grid``, ``build_grid``,
``grid_for_pore``) is numpy and equals the reference's array for array.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import kernels
from ..state import Measurements, ParticleState
from . import fp
from . import measure as measure_ops

_NO_PARTNER = 1 << 30


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
    box meets the gas region; the sweep does not use it (it sweeps every
    row) but the pairs engine will.
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


@dataclasses.dataclass(frozen=True)
class DeviceGrid:
    """Grid tables on the device: int32 nx, layer_base and neighbors, the
    working-dtype half_extent, and the scalars the kernels take."""

    nx: torch.Tensor           # (nz,) int32
    layer_base: torch.Tensor   # (nz,) int32
    half_extent: torch.Tensor  # (nz,) dtype
    neighbors: torch.Tensor    # (num_cells, 27) int32
    cell_size: float
    z_lo: float
    nz: int
    num_cells: int
    capacity: int

    @staticmethod
    def from_grid(grid: Grid, dtype, device) -> "DeviceGrid":
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
        )


# --------------------------------------------------------------------------
# K2: cell binning and cell table (collide.py:317-391)
# --------------------------------------------------------------------------


def assign_cells_plain(pos: torch.Tensor, grid: DeviceGrid) -> torch.Tensor:
    """(N,) int32 flat cell id per particle (strays clamp into edge
    cells), collide.py:324-349."""
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
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


def bin_and_table_plain(pos: torch.Tensor, grid: DeviceGrid):
    """Plain version of K2: (cell_id (N,), table (C+1, cap), pslot (N,),
    overflow ()) -- all int32, equal to the reference's assign_cells +
    build_cell_table.  The stable sort decides which particles keep a
    slot in a full cell: the lowest indices do."""
    n = pos.shape[0]
    cap = grid.capacity
    num_cells = grid.num_cells
    dev = pos.device
    cell_id = assign_cells_plain(pos, grid)
    sorted_cid, order = torch.sort(cell_id, stable=True)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    is_start[1:] = sorted_cid[1:] != sorted_cid[:-1]
    first = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    rank = idx - first
    in_cap = rank < cap
    overflow = torch.sum(~in_cap, dtype=torch.int32)
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


def bin_and_table(pos: torch.Tensor, grid: DeviceGrid):
    """K2 (see ``bin_and_table_plain``); CUDA kernel for CUDA tensors."""
    if kernels.use_plain(pos):
        return bin_and_table_plain(pos, grid)
    dev = pos.device
    n = pos.shape[0]
    cap = grid.capacity
    num_cells = grid.num_cells
    kernels.check(pos, "pos", torch.float32, (n, 3), dev)
    kernels.check(grid.nx, "grid.nx", torch.int32, (grid.nz,), dev)
    kernels.check(grid.layer_base, "grid.layer_base", torch.int32,
                  (grid.nz,), dev)
    kernels.check(grid.half_extent, "grid.half_extent", torch.float32,
                  (grid.nz,), dev)

    def i32(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    cell_id, pslot, seg = i32(n), i32(n), i32(n)
    counts, offsets, cursor = i32(num_cells), i32(num_cells), i32(num_cells)
    table = i32(num_cells + 1, cap)
    overflow = i32()
    p = kernels.ptr
    kernels.launch(
        "bin_and_table", dev, p(pos), n, p(grid.nx), p(grid.layer_base),
        p(grid.half_extent), grid.nz, grid.z_lo, grid.cell_size, num_cells,
        cap, p(cell_id), p(counts), p(offsets), p(cursor), p(seg), p(table),
        p(pslot), p(overflow),
    )
    return cell_id, table, pslot, overflow


# --------------------------------------------------------------------------
# K9: per-step partner sweep (collide.py:423-961, radius mode, top_k=1)
# --------------------------------------------------------------------------


def partner_sweep_plain(pos: torch.Tensor, table: torch.Tensor,
                        pslot: torch.Tensor, grid: DeviceGrid,
                        search_radius: float,
                        chunk: int = 1 << 15) -> torch.Tensor:
    """Plain version of K9: (N,) int32 lowest-index j != i in the 27
    neighbour cells of i's own row with d^2 < r^2, -1 for none.

    Works through the particles in chunks so the (chunk, 27*cap) candidate
    block stays small.  d^2 is formed as (dx*dx + dy*dy) + dz*dz with
    dx = x_i - x_j, the reference's order.
    """
    n = pos.shape[0]
    cap = grid.capacity
    dummy = grid.num_cells * cap
    r2 = search_radius * search_radius
    # A far row at index n stands in for the sentinel slots.
    pos_pad = torch.cat([pos, torch.full((1, 3), 1e9, dtype=pos.dtype,
                                         device=pos.device)])
    out = torch.empty(n, dtype=torch.int32, device=pos.device)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        s = pslot[lo:hi].long()
        listed = s < dummy
        cell = torch.where(listed, s // cap, 0)
        cand = table[grid.neighbors[cell].long()].reshape(hi - lo, 27 * cap)
        cl = cand.long()
        d = pos[lo:hi, None, :] - pos_pad[cl]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
        d2 = d2 + d[..., 2] * d[..., 2]
        own = torch.arange(lo, hi, dtype=torch.int32, device=pos.device)
        hit = (d2 < r2) & (cand < n) & (cand != own[:, None])
        best = torch.where(hit, cand, _NO_PARTNER).amin(dim=1)
        best = torch.where(listed & (best < _NO_PARTNER), best, -1)
        out[lo:hi] = best.to(torch.int32)
    return out


def partner_sweep(pos: torch.Tensor, table: torch.Tensor,
                  pslot: torch.Tensor, grid: DeviceGrid,
                  search_radius: float) -> torch.Tensor:
    """K9 (see ``partner_sweep_plain``); CUDA kernel for CUDA tensors.
    The kernel reads each table row up to its first sentinel, which holds
    for every table ``bin_and_table`` builds."""
    if kernels.use_plain(pos):
        return partner_sweep_plain(pos, table, pslot, grid, search_radius)
    dev = pos.device
    n = pos.shape[0]
    cap = grid.capacity
    kernels.check(pos, "pos", torch.float32, (n, 3), dev)
    kernels.check(table, "table", torch.int32, (grid.num_cells + 1, cap), dev)
    kernels.check(pslot, "pslot", torch.int32, (n,), dev)
    kernels.check(grid.neighbors, "grid.neighbors", torch.int32,
                  (grid.num_cells, 27), dev)
    partner = torch.empty(n, dtype=torch.int32, device=dev)
    p = kernels.ptr
    kernels.launch(
        "partner_sweep", dev, p(pos), p(table), p(pslot), p(grid.neighbors),
        n, grid.num_cells, cap, search_radius * search_radius, p(partner),
    )
    return partner


# --------------------------------------------------------------------------
# K10: impulse exchange (collide.py:1042-1142)
# --------------------------------------------------------------------------


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row dot product summed (x + y) + z, the reference's order."""
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def resolve_pairs_plain(state: ParticleState, measure: Measurements,
                        partner: torch.Tensor, collision_range: float):
    """Plain version of K10.  Returns (state, measure, n_collisions ()).

    A pair (a, b) is resolved iff partner[a] == b and partner[b] == a and
    they overlap and approach: t is the larger root of
    |dx - dv t|^2 = cr^2; both rewind by t, exchange the impulse along the
    contact normal and replay.  Completed paths are staged with the
    pre-collision velocity (record_completed) and path accumulators reset
    to the residual along the new direction (end_paths).
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

    measure = measure_ops.record_completed(
        measure, state.paths, state.has_collided, vel, t, ok)
    state = dataclasses.replace(
        state,
        pos=torch.where(ok[:, None], new_pos, pos),
        vel=torch.where(ok[:, None], new_vel, vel),
    )
    state = measure_ops.end_paths(state, ok, t, state.vel,
                                  zero_residual=False)
    n_collisions = torch.sum(ok, dtype=torch.int32) // 2
    return state, measure, n_collisions


def resolve_pairs(state: ParticleState, measure: Measurements,
                  partner: torch.Tensor, collision_range: float):
    """K10 (see ``resolve_pairs_plain``); CUDA kernel for CUDA tensors.
    Returns (state, measure, n_collisions ()) with ``collision_count``
    left to the caller, as in the plain version."""
    pos = state.pos
    if kernels.use_plain(pos):
        return resolve_pairs_plain(state, measure, partner, collision_range)
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
    outs = [torch.empty_like(t) for t, *_ in inputs if t is not partner]
    pos_o, vel_o, paths_o, has_o, pv_o, pm_o = outs
    ok_count = torch.empty((), dtype=torch.int32, device=dev)
    p = kernels.ptr
    cr = collision_range
    kernels.launch(
        "resolve_pairs", dev, *(p(t) for t, *_ in inputs), n, cr, cr * cr,
        *(p(t) for t in outs), p(ok_count),
    )
    state = ParticleState(pos=pos_o, vel=vel_o, paths=paths_o,
                          has_collided=has_o)
    measure = dataclasses.replace(measure, pending_vals=pv_o,
                                  pending_mask=pm_o)
    return state, measure, ok_count // 2
