"""z-slab domain-decomposed engine: S slabs, one process, a device a slab.

Port of ``argon_monte_carlo_tpu.parallel.shard`` in sweep mode.  The pore
is 1D-dominant along z, so each slab owns a contiguous z range with a
particle buffer of fixed capacity.  One step of every slab, in the
reference's order (shard.py:378-546):

1. invalid lanes are parked at a safe interior point, the workload's
   ``advance`` runs (drift, wall cases, recapture; K8 for the temperature
   pore), and the lanes get the far ``SENTINEL`` back;
2. *halo exchange*: the particles within ``halo_width = 2 x search
   radius`` of a slab face are packed (K12, up and down) and handed to the
   neighbouring slab;
3. *pair collisions* over local and ghost lanes together: K2 with
   ``valid``, K9 with the global ids, ``valid`` and the slab's cell window,
   K10 with ``local_mask``.  The halo is two search radii deep, so both
   slabs see the whole neighbourhood of a boundary particle and reach the
   same match; the impulse formula is symmetric, so a pair across a face is
   resolved on both sides with no result exchanged.  Each pair is counted
   once, on the slab whose lane holds the lower global id;
4. the post-pairs recapture under parking and the exact dense histogram
   flush (K7);
5. *migration*: the particles that crossed a slab face are packed (K12, up
   and down), handed over, and merged into the neighbour's free lanes (in
   ascending lane order, K6).

Where the reference is one SPMD program over a device mesh, the port is a
host loop: every slab does a phase before any slab does the next phase
that reads a neighbour, and an exchange is ``Tensor.to`` of the packed
buffer to the neighbour's device -- no copy at all where both slabs live on
one card.  State is a list with one ``(ParticleState, valid, gid)`` a
slab, and measurements one ``Measurements`` a slab; the per-step ledger is
summed over the slabs in slab order on the first slab's device, so a run is
repeatable to the bit.

``narrowphase="pairs"`` (the sharded Verlet list, shard.py:569-994) is not
ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .. import kernels
from ..config import cell_capacity_for, cell_size_for
from ..engine import Workload
from ..ops import collide
from ..ops import measure as measure_ops
from ..ops.compact import compact_indices
from ..ops.pack import SENTINEL, pack_band_pair
from ..state import Measurements, ParticleState, StepMetrics
from .mesh import make_devices

# Slab s draws its per-step uniforms from a Generator seeded with
# ``seed * SEED_STRIDE + 1 + s`` (the initial state comes from ``seed``).
SEED_STRIDE = 65_536


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Host-side decomposition plan (static per run); every field equals
    the reference's (shard.py:53-84)."""

    n_shards: int
    slab_z: np.ndarray        # (n_shards+1,) slab faces, on cell-layer edges
    cell_start: np.ndarray    # (n_shards,) first swept flat cell id
    cell_window: int          # swept-cell count (max over slabs)
    shard_capacity: int
    halo_capacity: int
    migration_capacity: int
    halo_width: float
    park: tuple[float, float, float]
    # The pairs narrow phase: a ghost band of 2 cells at the rebuild, its
    # cell windows, their slices of the sorted active-cell list, and a
    # migration buffer that covers the K steps between rebuilds.
    pairs_band_width: float = 0.0
    pairs_cell_start: Optional[np.ndarray] = None
    pairs_cell_window: int = 0
    pairs_halo_capacity: int = 0
    pairs_active_start: Optional[np.ndarray] = None
    pairs_active_window: int = 0
    pairs_migration_capacity: int = 0


def _volume_profile(geom, z_edges):
    """Fluid cross-section area integrated over each z interval."""
    def area(z):
        if z < geom.open_air_height or z >= geom.cold_top:
            return math.pi * geom.open_air_radius**2
        if geom.gap_bottom <= z < geom.gap_top:
            return math.pi * geom.gap_radius**2
        return math.pi * geom.pore_coated_radius**2

    mids = 0.5 * (z_edges[:-1] + z_edges[1:])
    widths = np.diff(z_edges)
    return np.array([area(m) for m in mids]) * widths


def make_shard_plan(workload: Workload, n_shards: int,
                    host_grid: collide.Grid) -> ShardPlan:
    """Slab cuts balanced by particle count on grid-layer edges, the swept
    cell window of each slab, and the buffer sizes (shard.py:104-207)."""
    cfg = workload.cfg
    geom = cfg.geometry
    physics = cfg.physics
    eng = cfg.engine
    n = cfg.num_molecules
    search_radius = physics.collision_range + eng.skin
    halo_width = 2.0 * search_radius

    cs = host_grid.cell_size
    z_edges = host_grid.z_lo + cs * np.arange(host_grid.nz + 1)
    vol = _volume_profile(geom, z_edges)
    cum = np.concatenate([[0.0], np.cumsum(vol)])
    cum /= cum[-1]
    cut_layers = [0]
    for k in range(1, n_shards):
        cut_layers.append(int(np.searchsorted(cum, k / n_shards)))
    cut_layers.append(host_grid.nz)
    cut_layers = np.maximum.accumulate(cut_layers)  # monotone safety
    slab_z = z_edges[cut_layers]
    slab_z[0] = host_grid.z_lo
    slab_z[-1] = host_grid.z_lo + cs * host_grid.nz

    # Each slab's particle share from the volume profile.
    shares = np.diff(cum[cut_layers])
    max_share = float(shares.max())
    shard_capacity = int(np.ceil(max_share * n * 1.3 / 8.0) * 8) + 8

    layer_cells = (host_grid.nx.astype(np.int64)) ** 2
    layer_cum = np.concatenate([[0], np.cumsum(layer_cells)])

    def windows(band_width):
        """Own layers +- halo layers: (first cell, cell count) a slab."""
        halo_layers = int(math.ceil(band_width / cs)) + 1
        starts, widths = [], []
        for s in range(n_shards):
            lo = max(cut_layers[s] - halo_layers, 0)
            hi = min(cut_layers[s + 1] + halo_layers, host_grid.nz)
            starts.append(int(layer_cum[lo]))
            widths.append(int(layer_cum[hi] - layer_cum[lo]))
        return starts, widths

    starts, widths = windows(halo_width)

    # Halo and migration buffers from the local density near the cuts.
    density = n / workload.fluid_volume
    max_area = vol.max() / cs  # widest cross-section
    band = density * max_area * halo_width
    halo_capacity = int(np.ceil((band * 4.0 + 64.0) / 8.0) * 8)
    # Crossings a step ~= density * area * mean |v_z| * dt; be generous.
    v_scale = 5.0 * physics.a_shape
    crossings = density * max_area * v_scale * cfg.dt
    migration_capacity = int(np.ceil((crossings * 8.0 + 64.0) / 8.0) * 8)

    pairs_band = 2.0 * cs
    starts_p, widths_p = windows(pairs_band)
    band_p = density * max_area * pairs_band
    pairs_halo_capacity = int(np.ceil((band_p * 3.0 + 64.0) / 8.0) * 8)
    if host_grid.active_cells is not None:
        act = host_grid.active_cells
        a_lo = np.searchsorted(act, np.asarray(starts_p, np.int64))
        a_hi = np.searchsorted(
            act, np.asarray(starts_p, np.int64)
            + np.asarray(widths_p, np.int64))
        pairs_active_start = a_lo.astype(np.int32)
        pairs_active_window = int((a_hi - a_lo).max())
    else:
        pairs_active_start = None
        pairs_active_window = 0
    k_steps = max(eng.rebuild_interval, 1)
    pairs_migration_capacity = int(
        np.ceil((crossings * 8.0 * k_steps + 64.0) / 8.0) * 8)

    return ShardPlan(
        n_shards=n_shards,
        slab_z=slab_z.astype(np.float64),
        cell_start=np.asarray(starts, np.int32),
        cell_window=max(widths),
        shard_capacity=shard_capacity,
        halo_capacity=halo_capacity,
        migration_capacity=migration_capacity,
        halo_width=float(halo_width),
        park=(0.0, 0.0, geom.total_height / 2.0),
        pairs_band_width=float(pairs_band),
        pairs_cell_start=np.asarray(starts_p, np.int32),
        pairs_cell_window=max(widths_p),
        pairs_halo_capacity=pairs_halo_capacity,
        pairs_migration_capacity=pairs_migration_capacity,
        pairs_active_start=pairs_active_start,
        pairs_active_window=pairs_active_window,
    )


@dataclasses.dataclass
class SlabConstants:
    """One slab's constants on its device: its grid, its faces and halo
    edges in the run's dtype, and the buffers it reads where it has no
    neighbour."""

    device: torch.device
    grid: collide.DeviceGrid
    cell_start: int
    park: torch.Tensor        # (3,)
    far: torch.Tensor         # () SENTINEL
    z_lo: torch.Tensor        # ()
    z_hi: torch.Tensor
    up_edge: torch.Tensor     # z_hi - halo_width
    down_edge: torch.Tensor   # z_lo + halo_width
    no_halo: tuple            # (buf, flag) of an unaddressed slab
    no_migrants: tuple
    ghost_paths: torch.Tensor  # (2 * hcap, 4) zeros
    ghost_false: torch.Tensor  # (2 * hcap,) False


def _empty_band(names, capacity: int, dtype, device):
    """What a slab without a neighbour on one side receives (the
    reference's zeros from ``ppermute``, then ``ghost_fix``): no slot
    filled, far positions."""
    shapes = {"pos": ((3,), dtype), "vel": ((3,), dtype),
              "paths": ((4,), dtype), "hc": ((), torch.bool),
              "gid": ((), torch.int32)}
    buf = {}
    for name in names:
        shape, dt = shapes[name]
        buf[name] = torch.full((capacity,) + shape,
                               SENTINEL if name == "pos" else 0, dtype=dt,
                               device=device)
    return buf, torch.zeros(capacity, dtype=torch.bool, device=device)


def _to_device(band, device):
    """The exchange: a packed band on the receiving slab's device (the
    same tensors where the sender lives there too)."""
    buf, flag = band
    return {k: v.to(device) for k, v in buf.items()}, flag.to(device)


def _scatter_rows(base: torch.Tensor, target: torch.Tensor,
                  rows: torch.Tensor) -> torch.Tensor:
    """``base`` with ``rows[k]`` written at lane ``target[k]``; a target
    equal to the lane count is dropped (the reference's
    ``.at[target].set(..., mode="drop")``): it lands in a spare last row
    that the returned view leaves out."""
    out = torch.empty((base.shape[0] + 1,) + tuple(base.shape[1:]),
                      dtype=base.dtype, device=base.device)
    out[:-1] = base
    out.index_copy_(0, target, rows)
    return out[:-1]


class ShardedSimulation:
    """Multi-slab counterpart of ``engine.Simulation`` (sweep mode).

    ``devices`` lists the devices the slabs are dealt over (default: every
    visible CUDA device, and it raises where there is none; the tests pass
    ``["cpu"]``); ``n_shards`` defaults to one slab a device.

    The initial state is drawn from one Generator seeded with the seed on
    the first slab's device and split on the host by z; after that slab s
    draws its (capacity, 2) uniforms a step from its own Generator on its
    own device, seeded with ``seed * SEED_STRIDE + 1 + s``.
    ``run(draw=...)`` replaces the draw, so a test can feed the reference's
    uniforms.
    """

    def __init__(self, workload: Workload, n_shards: Optional[int] = None,
                 devices: Optional[Sequence] = None):
        self.workload = workload
        self.cfg = workload.cfg
        cfg = self.cfg
        eng = cfg.engine
        if eng.narrowphase == "pairs":
            raise NotImplementedError(
                "ShardedSimulation runs narrowphase='sweep'; the sharded "
                "pairs mode is not ported yet (ROADMAP queue 1: next)")
        if eng.hist_flush_interval != 1:
            raise ValueError(
                "ShardedSimulation always flushes histograms every step "
                "(exact dense scatter); set hist_flush_interval=1 "
                f"(got {eng.hist_flush_interval})")
        if eng.broadphase != "cells" or not hasattr(cfg.geometry,
                                                    "total_height"):
            raise NotImplementedError(
                "ShardedSimulation runs the pore workloads on the cell "
                "grid (broadphase='cells')")
        # The devices as named, before any of them is touched, then the
        # ones taken by default (the visible CUDA devices).
        kernels.require_float32(eng.dtype, devices or [])
        self.dtype = eng.torch_dtype
        self.devices = make_devices(n_shards, devices)
        kernels.require_float32(eng.dtype, self.devices)
        args = (eng, cfg.physics, cfg.num_molecules, workload.fluid_volume)
        self.host_grid = collide.grid_for_pore(
            cfg.geometry, cell_size_for(*args), cell_capacity_for(*args))
        self._grids = {
            dev: collide.DeviceGrid.from_grid(self.host_grid, self.dtype, dev)
            for dev in set(self.devices)}
        self.plan = make_shard_plan(workload, len(self.devices),
                                    self.host_grid)

    # ------------------------------------------------------------------
    def slab_constants(self) -> list[SlabConstants]:
        """Per-slab constants for the plan as it stands now."""
        plan = self.plan
        dtype = self.dtype
        hcap, mcap = plan.halo_capacity, plan.migration_capacity
        # float64 on the host, the run's dtype on the device (shard.py:364):
        # the init split compares in float64, the migration in the dtype.
        slab_z = torch.as_tensor(plan.slab_z, dtype=dtype)
        out = []
        for s, dev in enumerate(self.devices):
            z_lo, z_hi = slab_z[s].to(dev), slab_z[s + 1].to(dev)
            out.append(SlabConstants(
                device=dev, grid=self._grids[dev],
                cell_start=int(plan.cell_start[s]),
                park=torch.tensor(plan.park, dtype=dtype, device=dev),
                far=torch.tensor(SENTINEL, dtype=dtype, device=dev),
                z_lo=z_lo, z_hi=z_hi,
                up_edge=z_hi - plan.halo_width,
                down_edge=z_lo + plan.halo_width,
                no_halo=_empty_band(("pos", "vel", "gid"), hcap, dtype, dev),
                no_migrants=_empty_band(("pos", "vel", "paths", "hc", "gid"),
                                        mcap, dtype, dev),
                ghost_paths=torch.zeros((2 * hcap, 4), dtype=dtype,
                                        device=dev),
                ghost_false=torch.zeros(2 * hcap, dtype=torch.bool,
                                        device=dev),
            ))
        return out

    def shard_state(self, state: ParticleState):
        """Split a global state over the slabs by z (on the host, in
        float64: ``searchsorted(slab_z, z, side="right") - 1``); lane k of
        a slab holds its k-th particle in global order, ``gid`` its global
        index.  Returns the list of (ParticleState, valid, gid)."""
        plan = self.plan
        cap = plan.shard_capacity
        arrays = {f.name: getattr(state, f.name).cpu().numpy()
                  for f in dataclasses.fields(ParticleState)}
        shard_of = np.clip(
            np.searchsorted(plan.slab_z, arrays["pos"][:, 2], side="right")
            - 1, 0, plan.n_shards - 1)
        slabs = []
        for s, dev in enumerate(self.devices):
            idx = np.nonzero(shard_of == s)[0]
            m = len(idx)
            if m > cap:
                raise ValueError(
                    f"shard {s} holds {m} > capacity {cap}; increase the "
                    "capacity factor")
            parts = {}
            for name, arr in arrays.items():
                buf = np.full((cap,) + arr.shape[1:],
                              SENTINEL if name == "pos" else 0, arr.dtype)
                buf[:m] = arr[idx]
                parts[name] = torch.as_tensor(buf, device=dev)
            valid = np.zeros(cap, bool)
            valid[:m] = True
            gid = np.zeros(cap, np.int32)
            gid[:m] = idx
            slabs.append((ParticleState(**parts),
                          torch.as_tensor(valid, device=dev),
                          torch.as_tensor(gid, device=dev)))
        return slabs

    def zero_measurements(self) -> list[Measurements]:
        """One Measurements a slab, its staging sized for the slab's local
        and ghost lanes together (shard.py:1040-1046)."""
        plan = self.plan
        lanes = plan.shard_capacity + 2 * plan.halo_capacity
        return [Measurements.zeros(self.cfg.engine.num_bins, self.dtype,
                                   num_particles=lanes, device=dev)
                for dev in self.devices]

    def init(self, seed: Optional[int] = None):
        """(state, measure, generators) for a fresh run: the per-slab
        lists, and each slab's Generator for its per-step draws."""
        seed = self.cfg.seed if seed is None else seed
        first = self.devices[0]
        gen = torch.Generator(device=first)
        gen.manual_seed(seed)
        state = self.shard_state(self.workload.init_fn(gen, first))
        generators = []
        for s, dev in enumerate(self.devices):
            g = torch.Generator(device=dev)
            g.manual_seed(seed * SEED_STRIDE + 1 + s)
            generators.append(g)
        return state, self.zero_measurements(), generators

    # ------------------------------------------------------------------
    def _step(self, slabs, state, measure, uniforms_of: Callable):
        """One step of every slab; returns (state, measure, StepMetrics)."""
        plan = self.plan
        cfg = self.cfg
        eng = cfg.engine
        workload = self.workload
        cr = cfg.physics.collision_range
        search_radius = cr + eng.skin
        hist_hi = eng.hist_range[1]
        cap = plan.shard_capacity
        hcap, mcap = plan.halo_capacity, plan.migration_capacity
        n_shards = plan.n_shards

        def parked(c, st, valid, fn):
            """Run a wall or recapture stage with the invalid lanes parked
            at a safe interior point, then give them the far sentinel
            back (shard.py:369-376)."""
            lanes = valid[:, None]
            out = fn(dataclasses.replace(
                st, pos=torch.where(lanes, st.pos, c.park)))
            st = out[0]
            return (dataclasses.replace(
                st, pos=torch.where(lanes, st.pos, c.far)),) + out[1:]

        # DRIFT, WALLS and recapture under parking (an invalid lane has
        # zero velocity, so it neither moves nor accrues a path), then the
        # halo bands.
        work = []
        for s, c in enumerate(slabs):
            st, valid, gid = state[s]
            st, meas, ledger, oob_walls, _, _ = parked(
                c, st, valid,
                lambda x: workload.advance(x, measure[s], uniforms_of(s)))
            # Both bands in one call: valid & (z > up_edge) up, valid &
            # (z < down_edge) down, packed on every slab (the reference
            # counts an edge slab's truncation too).
            (up, up_flag, d1), (down, down_flag, d2) = pack_band_pair(
                {"pos": st.pos, "vel": st.vel, "gid": gid}, valid, hcap,
                c.up_edge, c.down_edge)
            work.append(dict(st=st, valid=valid, gid=gid, meas=meas,
                             ledger=ledger, oob_walls=oob_walls,
                             up=(up, up_flag), down=(down, down_flag),
                             halo_trunc=d1 + d2))

        # PAIR COLLISIONS over local + ghost lanes, the post-pairs
        # recapture, the flush, and the migrants packed.
        for s, c in enumerate(slabs):
            w = work[s]
            st, valid, gid = w["st"], w["valid"], w["gid"]
            gb, gb_flag = _to_device(
                work[s - 1]["up"] if s > 0 else c.no_halo, c.device)
            ga, ga_flag = _to_device(
                work[s + 1]["down"] if s < n_shards - 1 else c.no_halo,
                c.device)
            pos_c = torch.cat([st.pos, gb["pos"], ga["pos"]])
            gid_c = torch.cat([gid, gb["gid"], ga["gid"]])
            valid_c = torch.cat([valid, gb_flag, ga_flag])
            local_c = torch.cat([valid, c.ghost_false])
            comb = ParticleState(
                pos=pos_c,
                vel=torch.cat([st.vel, gb["vel"], ga["vel"]]),
                paths=torch.cat([st.paths, c.ghost_paths]),
                has_collided=torch.cat([st.has_collided, c.ghost_false]))
            _, table, pslot, overflow = collide.bin_and_table(
                pos_c, c.grid, valid=valid_c)
            partner = collide.partner_sweep(
                pos_c, table, pslot, c.grid, search_radius, ids=gid_c,
                valid=valid_c, cell_window=(c.cell_start, plan.cell_window))
            comb, meas, _, ok = collide.resolve_pairs(
                comb, w["meas"], partner, cr, local_mask=local_c)
            # Each pair counts once: on the slab that owns the lower gid.
            partner_gid = gid_c[torch.clamp(partner, min=0).long()]
            pair_count = torch.sum(ok & local_c & (gid_c < partner_gid),
                                   dtype=torch.int32)
            st = ParticleState(pos=comb.pos[:cap], vel=comb.vel[:cap],
                               paths=comb.paths[:cap],
                               has_collided=comb.has_collided[:cap])
            st, oob_pairs = parked(c, st, valid, workload.post_pairs)
            # The dense flush: a slab's staged lanes may outnumber any
            # fixed compaction width, and the dense path is exact.
            meas = measure_ops.flush_hist(meas, eng.num_bins, hist_hi,
                                          capacity=cap + 2 * hcap)

            # The migrants, both directions in one call: valid & (z >=
            # z_hi) up, valid & (z < z_lo) down, none across an outer
            # face; the call also returns the lanes that stay.
            payload = {"pos": st.pos, "vel": st.vel, "paths": st.paths,
                       "hc": st.has_collided, "gid": gid}
            (up, up_flag, d3), (down, down_flag, d4), valid = pack_band_pair(
                payload, valid, mcap,
                c.z_hi if s < n_shards - 1 else None,
                c.z_lo if s > 0 else None, up_inclusive=True, rest=True)
            lanes = valid[:, None]
            st = dataclasses.replace(
                st, pos=torch.where(lanes, st.pos, c.far),
                vel=torch.where(lanes, st.vel, torch.zeros_like(c.far)))
            w.update(st=st, valid=valid, meas=meas, overflow=overflow,
                     pair_count=pair_count, oob_pairs=oob_pairs,
                     out_up=(up, up_flag), out_down=(down, down_flag),
                     lost=d3 + d4)

        # MERGE the incoming migrants into free lanes, then the counters.
        new_state, new_measure, floats, counts = [], [], [], []
        for s, c in enumerate(slabs):
            w = work[s]
            st, valid, gid, meas = w["st"], w["valid"], w["gid"], w["meas"]
            lo, lo_flag = _to_device(
                work[s - 1]["out_up"] if s > 0 else c.no_migrants, c.device)
            hi, hi_flag = _to_device(
                work[s + 1]["out_down"] if s < n_shards - 1
                else c.no_migrants,
                c.device)
            flag = torch.cat([lo_flag, hi_flag])
            # The free lanes in ascending order (the reference's stable
            # argsort(valid)), padded with cap: an incoming particle whose
            # rank finds no free lane gets the target cap and is dropped.
            free = compact_indices(~valid, 2 * mcap, cap)
            rank = torch.cumsum(flag.to(torch.int32), dim=0) - 1
            target = torch.where(flag, free[torch.clamp(rank, min=0).long()],
                                 cap).long()
            place = flag & (target < cap)

            def merged(base, name):
                return _scatter_rows(base, target,
                                     torch.cat([lo[name], hi[name]]))

            st = ParticleState(pos=merged(st.pos, "pos"),
                               vel=merged(st.vel, "vel"),
                               paths=merged(st.paths, "paths"),
                               has_collided=merged(st.has_collided, "hc"))
            gid = merged(gid, "gid")
            valid = _scatter_rows(valid, target, place)
            # Particles lost (migrants that did not fit the buffer or
            # found no free lane) go to overflow_count; halo truncation
            # only hides a particle from the neighbour's pair search and
            # is kept apart (shard.py:513-525).
            lost = torch.sum(flag & ~place, dtype=torch.int32) + w["lost"]
            ledger = w["ledger"]
            meas = dataclasses.replace(
                meas,
                overflow_count=meas.overflow_count + w["overflow"] + lost,
                halo_trunc_count=meas.halo_trunc_count + w["halo_trunc"],
                err_count=meas.err_count + ledger.errs,
                collision_count=(meas.collision_count + w["pair_count"]
                                 + ledger.wall_hits),
            )
            new_state.append((st, valid, gid))
            new_measure.append(meas)
            floats.append(torch.stack([ledger.momentum_z, ledger.energy_hot,
                                       ledger.energy_cold]))
            counts.append(torch.stack([
                w["pair_count"] + ledger.wall_hits, ledger.wall_hits,
                w["oob_walls"], w["oob_pairs"],
                self._nonfinite(st, valid)]))

        # The ledger over all slabs: summed in slab order on the first
        # slab's device.
        first = slabs[0].device
        total_f = floats[0]
        total_i = counts[0]
        for f, i in zip(floats[1:], counts[1:]):
            total_f = total_f + f.to(first)
            total_i = total_i + i.to(first)
        zero = torch.zeros((), dtype=torch.int32, device=first)
        metrics = StepMetrics(
            momentum_z=total_f[0], energy_hot=total_f[1],
            energy_cold=total_f[2], collisions=total_i[0],
            wall_hits=total_i[1], oob_after_walls=total_i[2],
            oob_after_pairs=total_i[3], nonfinite=total_i[4],
            rebuilt=zero, dirty_count=zero, latent_full=zero,
            teleports=zero, latent_research=zero,
        )
        return new_state, new_measure, metrics

    def _nonfinite(self, st: ParticleState, valid: torch.Tensor):
        """Non-finite elements over the valid lanes (shard.py:253-267)."""
        if not self.cfg.engine.check_finite:
            return torch.zeros((), dtype=torch.int32, device=valid.device)
        lanes = valid[:, None]
        return sum(torch.sum(~torch.isfinite(t) & lanes, dtype=torch.int32)
                   for t in (st.pos, st.vel, st.paths))

    # ------------------------------------------------------------------
    def run(self, num_steps: Optional[int] = None, seed=None, state=None,
            measure=None, generators=None, start_step: int = 0,
            draw: Optional[Callable[[int, int], torch.Tensor]] = None,
            epoch_callback=None):
        """Run ``num_steps`` steps in epochs of ``steps_per_epoch``; returns
        (state, measure, StepMetrics of (num_steps,) tensors on the first
        slab's device, or None for zero steps).

        ``draw(shard, step_index)`` supplies slab ``shard``'s (capacity, 2)
        uniforms of a step, on that slab's device; by default they come
        from ``generators``.  ``epoch_callback(metrics)`` is called after
        each epoch with that epoch's metrics."""
        if num_steps is None:
            num_steps = self.cfg.num_timesteps
        if state is None:
            state, measure, generators = self.init(seed)
        if draw is None:
            if generators is None:
                raise ValueError("pass the generators that init() returned, "
                                 "or a draw function")
            cap = self.plan.shard_capacity

            def draw(shard, _step_index):
                return torch.rand((cap, 2), generator=generators[shard],
                                  dtype=self.dtype,
                                  device=self.devices[shard])

        slabs = self.slab_constants()
        epochs = []
        spe = self.cfg.engine.steps_per_epoch
        step_index = start_step
        end = start_step + num_steps
        while step_index < end:
            steps = []
            for i in range(step_index, min(step_index + spe, end)):
                state, measure, metrics = self._step(
                    slabs, state, measure, lambda s, i=i: draw(s, i))
                steps.append(metrics)
            epoch = StepMetrics.stack(steps)
            epochs.append(epoch)
            if epoch_callback is not None:
                epoch_callback(epoch)
            step_index += len(steps)
        stacked = StepMetrics.concat(epochs) if epochs else None
        return state, measure, stacked

    def finalize_measure(self, measure: list[Measurements]) -> Measurements:
        """The slabs' accumulators and counters summed into global totals
        (in slab order, on the first slab's device); the staging, which is
        per lane, is left empty."""
        first = self.devices[0]
        total = Measurements.zeros(self.cfg.engine.num_bins, self.dtype,
                                   num_particles=0, device=first)
        names = [f.name for f in dataclasses.fields(Measurements)
                 if not f.name.startswith("pending_")]
        for m in measure:
            total = dataclasses.replace(total, **{
                name: getattr(total, name) + getattr(m, name).to(first)
                for name in names})
        return total
