"""z-slab domain-decomposed engine: S slabs, one process, a device a slab.

Port of ``argon_monte_carlo_tpu.parallel.shard``.  The pore is
1D-dominant along z, so each slab owns a contiguous z range with a
particle buffer of fixed capacity; the cube is cut the same way, on the
box's centred cell grid.  One step of the sweep (``narrowphase="sweep"``)
on every slab, in the reference's order (shard.py:378-546):

1. invalid lanes are parked at a safe interior point, the workload's
   ``advance`` runs (drift, wall cases, recapture; K8 for the temperature
   pore), and the lanes get the far ``SENTINEL`` back;
2. *halo exchange*: the particles within ``halo_width = 2 x search
   radius`` of a slab face are packed (K12, up and down) and handed to the
   neighbouring slab;
3. *pair collisions* over local and ghost lanes together: K2 with
   ``valid``, K9 with the global ids (as the identity and as the order of
   the candidates), ``valid`` and the slab's cell window, K10 with
   ``local_mask``.  The halo is two search radii deep, so both slabs see
   the whole neighbourhood of a boundary particle, and as both choose each
   particle's partner of the lowest global id -- the one-card rule -- they
   reach the same match (the reference takes the lowest lane, which the
   two slabs number differently, and its sharded cube drifts in energy for
   it); the impulse formula is symmetric, so a pair across a face is
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

The pairs mode (``narrowphase="pairs"``, the sharded Verlet list,
shard.py:569-1121) keeps the lanes of a slab fixed for a window of
``rebuild_interval`` steps.  At each window boundary (``_pairs_rebuild``):
the crossers the window accumulated migrate (K12 packs them, K6 finds the
free lanes, as the sweep's merge does); each slab freezes the lists of its
lanes within two cells of a face (K12's index form) and hands their
positions, velocities and global ids to the neighbour as ghosts; and the
pair list is rebuilt on the local and ghost lanes together (K2 with
``valid``, K1 with the global ids and the slab's cell windows, K5 with the
valid lanes).  Each step (``_pairs_step``): K8 under parking; the ghosts
are refreshed through the frozen lists, with the owner's wall-bump and
wall-recapture flags; K3 tests the listed pairs with the global ids (both
slabs holding a pair across a face make the same match and apply the
same update, so a ghost mirrors its owner bit for bit) and stages and
counts local lanes only; the post-pairs recapture runs on all lanes; the
dirty lanes are compacted with the flush's (K6) and re-searched (K4,
"not itself" by global id); the compacted flush (K7c); the local lanes
are written back.  The ghosts' state is recomputed from the owners every
step, so nothing but the frozen lists outlives a step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .. import kernels
from ..engine import (Workload, build_grids, copy_tensors, missed_counts,
                      pairs_config_for, shared_compaction)
from ..ops import collide
from ..ops import measure as measure_ops
from ..ops import pairs as pairs_ops
from ..ops.compact import compact_indices
from ..ops.pack import SENTINEL, pack_band_pair, pack_indices
from ..state import Measurements, ParticleState, StepMetrics
from .mesh import make_devices

# Slab s draws its per-step uniforms from a Generator seeded with
# ``seed * SEED_STRIDE + 1 + s`` (the initial state comes from ``seed``).
SEED_STRIDE = 65_536


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Host-side decomposition plan (static per run); every field equals
    the reference's (shard.py:53-84) but the cube's ``halo_capacity``,
    which also holds a step's drift (``make_shard_plan``)."""

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
        if not hasattr(geom, "total_height"):  # the cube
            return geom.lx * geom.ly
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
    # The sweep's bands reach halo_width past the farthest particle that
    # crossed a face in the step (ShardedSimulation._reach_edges), so they
    # hold that step's z-drift too: 6 sigma of |v_z| dt with sigma =
    # v_rms / sqrt(3).  The pores drift a fraction of a collision range a
    # step and keep the reference's capacity; the cube drifts several.
    drift = 6.0 * physics.v_mean / math.sqrt(3.0) * cfg.dt
    band_drift = density * max_area * (halo_width + drift)
    halo_capacity = max(halo_capacity,
                        int(np.ceil((band_drift * 1.5 + 64.0) / 8.0) * 8))
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
    if hasattr(geom, "total_height"):
        park = (0.0, 0.0, geom.total_height / 2.0)
    else:  # the cube's centre
        park = (geom.lx / 2.0, geom.ly / 2.0, geom.lz / 2.0)

    return ShardPlan(
        n_shards=n_shards,
        slab_z=slab_z.astype(np.float64),
        cell_start=np.asarray(starts, np.int32),
        cell_window=max(widths),
        shard_capacity=shard_capacity,
        halo_capacity=halo_capacity,
        migration_capacity=migration_capacity,
        halo_width=float(halo_width),
        park=park,
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
    # hcap and the migrants' capacity are the mode's (``_capacities``).


def _empty_band(names, capacity: int, dtype, device, gid: int = 0):
    """What a slab without a neighbour on one side receives (the
    reference's zeros from ``ppermute``, then ``ghost_fix``): no slot
    filled, far positions, ids ``gid``."""
    shapes = {"pos": ((3,), dtype), "vel": ((3,), dtype),
              "paths": ((4,), dtype), "hc": ((), torch.bool),
              "gid": ((), torch.int32), "fl": ((), torch.uint8)}
    fill = {"pos": SENTINEL, "gid": gid}
    buf = {}
    for name in names:
        shape, dt = shapes[name]
        buf[name] = torch.full((capacity,) + shape, fill.get(name, 0),
                               dtype=dt, device=device)
    return buf, torch.zeros(capacity, dtype=torch.bool, device=device)


def _to_device(band, device):
    """The exchange: a packed band, (buf, flag or None), on the receiving
    slab's device (the same tensors where the sender lives there too)."""
    buf, flag = band
    return ({k: v.to(device) for k, v in buf.items()},
            None if flag is None else flag.to(device))


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


def _take(rows: torch.Tensor, idx: torch.Tensor, flag: torch.Tensor,
          fill) -> torch.Tensor:
    """``rows`` at the lanes of an export list, ``fill`` where its slot is
    empty (shard.py:700-708, 807-819)."""
    got = rows[torch.clamp(idx, max=rows.shape[0] - 1).long()]
    keep = flag.view((-1,) + (1,) * (rows.dim() - 1))
    return torch.where(keep, got, torch.full((), fill, dtype=rows.dtype,
                                             device=rows.device))


class ShardedSimulation:
    """Multi-slab counterpart of ``engine.Simulation``: the pores with
    either narrow phase and the cube with the sweep, on the cell grid.

    ``devices`` lists the devices the slabs are dealt over (default: every
    visible CUDA device, and it raises where there is none; the tests pass
    ``["cpu"]``); ``n_shards`` defaults to one slab a device.

    The initial state is drawn from one Generator seeded with the seed on
    the first slab's device and split on the host by z; after that slab s
    draws its (capacity, 2) uniforms a step from its own Generator on its
    own device, seeded with ``seed * SEED_STRIDE + 1 + s``.
    ``run(draw=...)`` replaces the draw, so a test can feed the reference's
    uniforms.

    In pairs mode the engine carries each slab's ``PairWindow`` and the
    steps left in the window across epochs and runs, as ``Simulation``
    carries its pair list, and drops them when ``run`` gets a state other
    than the one it last returned (shard.py:1049-1121).
    """

    def __init__(self, workload: Workload, n_shards: Optional[int] = None,
                 devices: Optional[Sequence] = None):
        self.workload = workload
        self.cfg = workload.cfg
        cfg = self.cfg
        eng = cfg.engine
        if eng.hist_flush_interval != 1:
            raise ValueError(
                "ShardedSimulation always flushes histograms every step "
                "(exact dense scatter); set hist_flush_interval=1 "
                f"(got {eng.hist_flush_interval})")
        if eng.broadphase != "cells":
            raise NotImplementedError(
                "ShardedSimulation runs on the cell grid "
                "(broadphase='cells')")
        # The devices as named, before any of them is touched, then the
        # ones taken by default (the visible CUDA devices).
        kernels.require_float32(eng.dtype, devices or [])
        self.dtype = eng.torch_dtype
        self.devices = make_devices(n_shards, devices)
        kernels.require_float32(eng.dtype, self.devices)
        # The pairs grid has the tighter capacity, the cube's is centred on
        # the box (shard.py:315-337), as on one card.
        self._grids = {}
        for dev in dict.fromkeys(self.devices):
            self.host_grid, self._grids[dev] = build_grids(workload, dev)
        self.plan = make_shard_plan(workload, len(self.devices),
                                    self.host_grid)
        self._pairs_mode = eng.narrowphase == "pairs"
        self._windows = None
        self._window_left = 0
        self._last_state_out = None
        if self._pairs_mode:
            plan = self.plan
            self.pcfg = pairs_config_for(
                workload, num_particles=plan.shard_capacity
                + 2 * plan.pairs_halo_capacity)

    # ------------------------------------------------------------------
    def _capacities(self) -> tuple[int, int]:
        """(ghost lanes a side, migrant slots a side) of the mode: the
        pairs mode's are its window's (shard.py:617-618)."""
        plan = self.plan
        if self._pairs_mode:
            return plan.pairs_halo_capacity, plan.pairs_migration_capacity
        return plan.halo_capacity, plan.migration_capacity

    def slab_constants(self) -> list[SlabConstants]:
        """Per-slab constants for the plan as it stands now."""
        plan = self.plan
        dtype = self.dtype
        hcap, mcap = self._capacities()
        # The pairs mode's ghosts carry the owner's dirty flags, and a
        # missing one the reference's id -3 (shard.py:706, 715).
        halo = (("pos", "vel", "gid", "fl") if self._pairs_mode
                else ("pos", "vel", "gid"))
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
                no_halo=_empty_band(halo, hcap, dtype, dev,
                                    gid=-3 if self._pairs_mode else 0),
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
        and ghost lanes together (shard.py:1038-1046)."""
        lanes = self.plan.shard_capacity + 2 * self._capacities()[0]
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
    def _parked(self, c: SlabConstants, st: ParticleState,
                valid: torch.Tensor, fn):
        """Run a wall or recapture stage with the invalid lanes parked at a
        safe interior point, then give them the far sentinel back
        (shard.py:369-376)."""
        lanes = valid[:, None]
        out = fn(dataclasses.replace(
            st, pos=torch.where(lanes, st.pos, c.park)))
        st = out[0]
        return (dataclasses.replace(
            st, pos=torch.where(lanes, st.pos, c.far)),) + out[1:]

    def _pack_migrants(self, s: int, c: SlabConstants, st: ParticleState,
                       valid: torch.Tensor, gid: torch.Tensor,
                       capacity: int):
        """The migrants of slab s, both directions in one call: valid &
        (z >= z_hi) up, valid & (z < z_lo) down, none across an outer
        face (shard.py:477-491).  Returns (state with the leavers far and
        at rest, the lanes that stay, up (buf, flag), down (buf, flag),
        the migrants that did not fit)."""
        last = self.plan.n_shards - 1
        payload = {"pos": st.pos, "vel": st.vel, "paths": st.paths,
                   "hc": st.has_collided, "gid": gid}
        (up, up_flag, d_up), (down, down_flag, d_down), valid = \
            pack_band_pair(payload, valid, capacity,
                           c.z_hi if s < last else None,
                           c.z_lo if s > 0 else None, up_inclusive=True,
                           rest=True)
        lanes = valid[:, None]
        st = dataclasses.replace(
            st, pos=torch.where(lanes, st.pos, c.far),
            vel=torch.where(lanes, st.vel, torch.zeros_like(c.far)))
        return st, valid, (up, up_flag), (down, down_flag), d_up + d_down

    def _merge_migrants(self, c: SlabConstants, st: ParticleState,
                        valid: torch.Tensor, gid: torch.Tensor, lo, hi,
                        capacity: int):
        """The migrants from below (``lo``) and above (``hi``), each
        (buf, flag), merged into the free lanes in ascending lane order
        (the reference's stable argsort(valid), shard.py:493-512).  Returns
        (state, valid, gid, the migrants that found no free lane)."""
        cap = self.plan.shard_capacity
        lo, lo_flag = _to_device(lo, c.device)
        hi, hi_flag = _to_device(hi, c.device)
        flag = torch.cat([lo_flag, hi_flag])
        # The free lanes in ascending order, padded with cap: an incoming
        # particle whose rank finds no free lane gets the target cap and
        # is dropped.
        free = compact_indices(~valid, 2 * capacity, cap)
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
        return (st, _scatter_rows(valid, target, place), merged(gid, "gid"),
                torch.sum(flag & ~place, dtype=torch.int32))

    def _metrics(self, slabs, floats, counts, missed, rebuilt=None):
        """The step's ledger over all slabs: summed in slab order on the
        first slab's device; with ``rebuilt`` (the pairs mode) also its
        four counters."""
        first = slabs[0].device
        total_f, total_i, total_missed = floats[0], counts[0], missed[0]
        for s in range(1, len(slabs)):
            total_f = total_f + floats[s].to(first)
            total_i = total_i + counts[s].to(first)
            total_missed = total_missed + missed[s].to(first)
        zero = torch.zeros((), dtype=torch.int32, device=first)
        extra = dict(rebuilt=zero, dirty_count=zero, latent_full=zero,
                     teleports=zero, latent_research=zero)
        if rebuilt is not None:
            extra = dict(rebuilt=rebuilt, dirty_count=total_i[5],
                         latent_full=total_i[6], teleports=total_i[7],
                         latent_research=total_i[8])
        return StepMetrics(
            momentum_z=total_f[0], energy_hot=total_f[1],
            energy_cold=total_f[2], collisions=total_i[0],
            wall_hits=total_i[1], oob_after_walls=total_i[2],
            oob_after_pairs=total_i[3], missed_cases=total_missed,
            nonfinite=total_i[4], **extra)

    def _reach_edges(self, slabs, work, width: float):
        """Each slab's (up_edge, down_edge) of the sweep's halo bands: the
        plan's, moved to ``width`` below the lowest particle of the slab
        above and ``width`` above the highest one of the slab below where
        those lie past the face (0-d tensors on the slab's device)."""
        def extreme(w, fn, empty):
            z = torch.where(w["valid"], w["st"].pos[:, 2], empty)
            return fn(z)

        out = []
        for s, c in enumerate(slabs):
            up, down = c.up_edge, c.down_edge
            if s + 1 < len(slabs):
                low = extreme(work[s + 1], torch.amin, SENTINEL)
                up = torch.minimum(up, low.to(c.device) - width)
            if s > 0:
                high = extreme(work[s - 1], torch.amax, -SENTINEL)
                down = torch.maximum(down, high.to(c.device) + width)
            out.append((up, down))
        return out

    def _step(self, slabs, state, measure, uniforms_of: Callable):
        """One sweep step of every slab; returns (state, measure,
        StepMetrics)."""
        plan = self.plan
        cfg = self.cfg
        eng = cfg.engine
        workload = self.workload
        cr = cfg.physics.collision_range
        search_radius = cr + eng.skin
        hist_hi = eng.hist_range[1]
        cap = plan.shard_capacity
        hcap, mcap = self._capacities()
        n_shards = plan.n_shards
        audits = eng.debug_audits and workload.audit_fn is not None
        parked = self._parked

        # DRIFT, WALLS and recapture under parking (an invalid lane has
        # zero velocity, so it neither moves nor accrues a path).  The
        # missed-case audit runs inside ``advance`` on the parked lanes, so
        # an invalid lane trips no predicate (shard.py:397-405).
        work = []
        for s, c in enumerate(slabs):
            st, valid, gid = state[s]
            sink, missed = missed_counts(c.device, audits)
            st, meas, ledger, oob_walls, _, _ = parked(
                c, st, valid,
                lambda x: workload.advance(x, measure[s], uniforms_of(s),
                                           missed=sink))
            work.append(dict(st=st, valid=valid, gid=gid, meas=meas,
                             ledger=ledger, oob_walls=oob_walls,
                             missed=missed))
        # The halo bands, both in one call: valid & (z > up_edge) up,
        # valid & (z < down_edge) down, packed on every slab (the reference
        # counts an edge slab's truncation too).  A slab's particles that
        # crossed a face this step are still its own in the pair phase, so
        # a band reaches halo_width past the receiving slab's farthest
        # particle when that lies beyond the face: the reference's fixed
        # edges leave such a crosser's partners unseen by its owner while
        # their own slab resolves the pair (the cube drifts several
        # collision ranges a step, and the reference's sharded cube loses
        # energy for it); the pores' crossers stay within the fixed bands.
        reach = self._reach_edges(slabs, work, plan.halo_width)
        for s, c in enumerate(slabs):
            w = work[s]
            up_edge, down_edge = reach[s]
            (up, up_flag, d1), (down, down_flag, d2) = pack_band_pair(
                {"pos": w["st"].pos, "vel": w["st"].vel, "gid": w["gid"]},
                w["valid"], hcap, up_edge, down_edge)
            w.update(up=(up, up_flag), down=(down, down_flag),
                     halo_trunc=d1 + d2)

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
            st, valid, out_up, out_down, lost = self._pack_migrants(
                s, c, st, valid, gid, mcap)
            w.update(st=st, valid=valid, meas=meas, overflow=overflow,
                     pair_count=pair_count, oob_pairs=oob_pairs,
                     out_up=out_up, out_down=out_down, lost=lost)

        # MERGE the incoming migrants into free lanes, then the counters.
        new_state, new_measure, floats, counts, missed = [], [], [], [], []
        for s, c in enumerate(slabs):
            w = work[s]
            st, valid, gid, lost = self._merge_migrants(
                c, w["st"], w["valid"], w["gid"],
                work[s - 1]["out_up"] if s > 0 else c.no_migrants,
                work[s + 1]["out_down"] if s < n_shards - 1
                else c.no_migrants, mcap)
            # Particles lost (migrants that did not fit the buffer or
            # found no free lane) go to overflow_count; halo truncation
            # only hides a particle from the neighbour's pair search and
            # is kept apart (shard.py:513-525).
            ledger = w["ledger"]
            meas = w["meas"]
            meas = dataclasses.replace(
                meas,
                overflow_count=(meas.overflow_count + w["overflow"] + lost
                                + w["lost"]),
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
            missed.append(w["missed"])
        return new_state, new_measure, self._metrics(slabs, floats, counts,
                                                     missed)

    # ------------------------------------------------------------------
    def _pairs_rebuild(self, slabs, state, measure):
        """The window boundary of the pairs mode (shard.py:645-744), in
        phases over the slabs: the crossers migrate, each slab freezes its
        export lists and captures its ghosts, and the pair list is rebuilt
        on its local and ghost lanes.  Returns (state, measure, the
        PairWindow of each slab)."""
        plan = self.plan
        cfg = self.cfg
        hcap, mcap = self._capacities()
        last = plan.n_shards - 1
        band = plan.pairs_band_width
        dtype = self.dtype

        packed = [self._pack_migrants(s, c, st, valid, gid, mcap)
                  for s, (c, (st, valid, gid)) in enumerate(zip(slabs,
                                                                state))]
        merged, exports = [], []
        for s, c in enumerate(slabs):
            st, valid, _, _, lost = packed[s]
            st, valid, gid, unplaced = self._merge_migrants(
                c, st, valid, state[s][2],
                packed[s - 1][2] if s > 0 else c.no_migrants,
                packed[s + 1][3] if s < last else c.no_migrants, mcap)
            # The export lists, frozen for the window: the lanes within a
            # band of two cells of a face with a neighbour.
            z = st.pos[:, 2]
            nobody = torch.zeros_like(valid)
            up_idx, up_flag, t_up = pack_indices(
                valid & (z > c.z_hi - band) if s < last else nobody, hcap)
            dn_idx, dn_flag, t_dn = pack_indices(
                valid & (z < c.z_lo + band) if s > 0 else nobody, hcap)
            meas = measure[s]
            meas = dataclasses.replace(
                meas,
                overflow_count=meas.overflow_count + lost + unplaced,
                halo_trunc_count=meas.halo_trunc_count + t_up + t_dn)
            merged.append((st, valid, gid, meas))

            def export(idx, flag):
                return ({"pos": _take(st.pos, idx, flag, SENTINEL),
                         "vel": _take(st.vel, idx, flag, 0.0),
                         "gid": _take(gid, idx, flag, -3)}, flag)

            exports.append(dict(up=export(up_idx, up_flag),
                                down=export(dn_idx, dn_flag),
                                lists=(up_idx, up_flag, dn_idx, dn_flag)))

        new_state, new_measure, windows = [], [], []
        for s, c in enumerate(slabs):
            st, valid, gid, meas = merged[s]
            gb, flag_b = _to_device(
                exports[s - 1]["up"] if s > 0 else c.no_halo, c.device)
            ga, flag_a = _to_device(
                exports[s + 1]["down"] if s < last else c.no_halo, c.device)
            valid_c = torch.cat([valid, flag_b, flag_a])
            comb = ParticleState(
                pos=torch.cat([st.pos, gb["pos"], ga["pos"]]),
                vel=torch.cat([st.vel, gb["vel"], ga["vel"]]),
                paths=None, has_collided=None)
            old = (self._windows[s].plist if self._windows is not None
                   else pairs_ops.PairList.init(
                       valid_c.shape[0], c.grid, self.pcfg, dtype,
                       c.device))
            active = (None if plan.pairs_active_start is None
                      else (int(plan.pairs_active_start[s]),
                            plan.pairs_active_window))
            plist = pairs_ops.rebuild(
                comb, c.grid, self.pcfg, cfg.physics.collision_range,
                cfg.dt, old, ids=torch.cat([gid, gb["gid"], ga["gid"]]),
                valid_lanes=valid_c,
                cell_window=(int(plan.pairs_cell_start[s]),
                             plan.pairs_cell_window),
                active_window=active)
            windows.append(pairs_ops.PairWindow(
                plist, *exports[s]["lists"], gid_b=gb["gid"], flag_b=flag_b,
                gid_a=ga["gid"], flag_a=flag_a))
            new_state.append((st, valid, gid))
            new_measure.append(meas)
        return new_state, new_measure, windows

    def _pairs_step(self, slabs, state, measure, uniforms_of: Callable,
                    rebuilt: bool):
        """One step of the pairs mode on every slab (shard.py:771-974);
        updates ``self._windows`` and returns (state, measure,
        StepMetrics)."""
        plan = self.plan
        cfg = self.cfg
        eng = cfg.engine
        workload = self.workload
        pcfg = self.pcfg
        cr, dt = cfg.physics.collision_range, cfg.dt
        hist_hi = eng.hist_range[1]
        cap = plan.shard_capacity
        last = plan.n_shards - 1
        audits = eng.debug_audits and workload.audit_fn is not None
        parked = self._parked

        # DRIFT, WALLS and recapture of the local lanes under parking, then
        # the exports through the frozen lists: post-wall state and the
        # owner's dirty flags (bit 0 the speed changed, bit 1 recaptured).
        work = []
        for s, c in enumerate(slabs):
            st, valid, gid = state[s]
            win = self._windows[s]
            sink, missed = missed_counts(c.device, audits)
            st, meas, ledger, oob_walls, recap_w, speed_pre = parked(
                c, st, valid,
                lambda x: workload.advance(x, measure[s], uniforms_of(s),
                                           missed=sink))
            recap_w = recap_w & valid
            wall_bump = (measure_ops.speed(st.vel) != speed_pre) & valid
            flags = wall_bump.to(torch.uint8) | (recap_w.to(torch.uint8) << 1)

            def export(idx, flag):
                return {"pos": _take(st.pos, idx, flag, SENTINEL),
                        "vel": _take(st.vel, idx, flag, 0.0),
                        "fl": _take(flags, idx, flag, 0)}

            work.append(dict(st=st, meas=meas, ledger=ledger,
                             oob_walls=oob_walls, missed=missed,
                             recap_w=recap_w, wall_bump=wall_bump,
                             up=export(win.up_idx, win.up_flag),
                             down=export(win.dn_idx, win.dn_flag)))

        new_state, new_measure, floats, counts, missed = [], [], [], [], []
        for s, c in enumerate(slabs):
            w = work[s]
            st, meas, ledger = w["st"], w["meas"], w["ledger"]
            _, valid, gid = state[s]
            win = self._windows[s]
            plist = win.plist
            gb, _ = _to_device((work[s - 1]["up"], None) if s > 0
                               else c.no_halo, c.device)
            ga, _ = _to_device((work[s + 1]["down"], None) if s < last
                               else c.no_halo, c.device)
            gid_c = torch.cat([gid, win.gid_b, win.gid_a])
            valid_c = torch.cat([valid, win.flag_b, win.flag_a])
            local_c = torch.cat([valid, c.ghost_false])
            fb, fa = win.flag_b[:, None], win.flag_a[:, None]
            comb = ParticleState(
                pos=torch.cat([st.pos, torch.where(fb, gb["pos"], c.far),
                               torch.where(fa, ga["pos"], c.far)]),
                vel=torch.cat([st.vel, gb["vel"], ga["vel"]]),
                paths=torch.cat([st.paths, c.ghost_paths]),
                has_collided=torch.cat([st.has_collided, c.ghost_false]))
            n = comb.num_particles

            # PAIR COLLISIONS on the listed lanes, in place on comb and the
            # staging; the match by global id, staged and counted locally.
            comb, meas, pair_count, collided = pairs_ops.test_and_resolve(
                comb, meas, plist.a, plist.b, cr, pcfg.event_capacity,
                ids=gid_c, local_mask=local_c)
            # POST-PAIRS RECAPTURE on every lane: deterministic, so a
            # ghost is recaptured as its owner is.
            pos_pre = comb.pos
            comb, _ = parked(c, comb, valid_c, workload.post_pairs)
            recap_p = torch.any(comb.pos != pos_pre, dim=-1)
            oob_pairs = torch.sum(recap_p[:cap] & valid, dtype=torch.int32)

            # DIRTY lanes: a ghost's wall flags are its owner's.
            bump = torch.cat([w["wall_bump"], (gb["fl"] & 1).bool(),
                              (ga["fl"] & 1).bool()])
            recap_w = torch.cat([w["recap_w"], (gb["fl"] >> 1).bool(),
                                 (ga["fl"] >> 1).bool()])
            bump = (bump | collided) & valid_c
            teleported = recap_w | recap_p
            hot = plist.hot | (teleported & valid_c)
            latent_full = torch.sum(plist.pending1 & local_c,
                                    dtype=torch.int32)
            dirty = (bump | hot | plist.pending1) & valid_c

            shared_idx, dirty_idx, research_dropped = shared_compaction(
                meas.pending_mask, dirty, pcfg.research_capacity)
            plist = dataclasses.replace(plist, hot=hot)
            plist, research_lost, latent_per = pairs_ops.research_dirty(
                comb, plist, dirty_idx, bump, c.grid, pcfg, cr, dt,
                ids=gid_c)
            counted = (dirty_idx < n) & local_c[torch.clamp(
                dirty_idx, max=n - 1).long()]
            latent_research = torch.sum(
                torch.where(counted, latent_per, 0), dtype=torch.int32)
            force = research_lost | (research_dropped > 0)
            meas = measure_ops.flush_hist_compacted(meas, shared_idx,
                                                    eng.num_bins, hist_hi)
            meas = dataclasses.replace(
                meas,
                overflow_count=(meas.overflow_count + plist.overflow
                                + research_dropped),
                hot_spill_count=meas.hot_spill_count + plist.spill,
                err_count=meas.err_count + ledger.errs,
                collision_count=meas.collision_count + ledger.wall_hits)
            zero = torch.zeros((), dtype=torch.int32, device=c.device)
            plist = dataclasses.replace(
                plist, pending1=torch.zeros_like(plist.pending1),
                age=torch.where(force, pairs_ops.INT_BIG, plist.age + 1),
                overflow=zero, spill=zero)
            self._windows[s] = dataclasses.replace(win, plist=plist)

            # WRITE BACK the local lanes.
            st = ParticleState(pos=comb.pos[:cap], vel=comb.vel[:cap],
                               paths=comb.paths[:cap],
                               has_collided=comb.has_collided[:cap])
            new_state.append((st, valid, gid))
            new_measure.append(meas)
            floats.append(torch.stack([ledger.momentum_z, ledger.energy_hot,
                                       ledger.energy_cold]))
            counts.append(torch.stack([
                pair_count + ledger.wall_hits, ledger.wall_hits,
                w["oob_walls"], oob_pairs, self._nonfinite(st, valid),
                torch.sum(dirty, dtype=torch.int32), latent_full,
                torch.sum(teleported & local_c, dtype=torch.int32),
                latent_research]))
            missed.append(w["missed"])
        first = slabs[0].device
        return new_state, new_measure, self._metrics(
            slabs, floats, counts, missed,
            rebuilt=torch.full((), int(rebuilt), dtype=torch.int32,
                               device=first))

    def _nonfinite(self, st: ParticleState, valid: torch.Tensor):
        """Non-finite elements over the valid lanes (shard.py:253-267)."""
        if not self.cfg.engine.check_finite:
            return torch.zeros((), dtype=torch.int32, device=valid.device)
        lanes = valid[:, None]
        return sum(torch.sum(~torch.isfinite(t) & lanes, dtype=torch.int32)
                   for t in (st.pos, st.vel, st.paths))

    # ------------------------------------------------------------------
    def pair_window(self):
        """(the PairWindow of each slab, steps left in the window) for a
        checkpoint, or None (the sweep, or no window open)."""
        if not self._pairs_mode or self._windows is None:
            return None
        return self._windows, self._window_left

    def resume_pair_window(self, state, windows, window_left: int):
        """Carry ``windows`` (a PairWindow a slab), with ``window_left``
        steps left, into the next ``run`` from ``state``, as if this engine
        had returned that state: a resumed run then rebuilds and migrates
        on the uninterrupted run's steps."""
        if not self._pairs_mode:
            raise ValueError("resume_pair_window: narrowphase='sweep' "
                             "carries no pair list")
        if len(windows) != self.plan.n_shards:
            raise ValueError(f"resume_pair_window: {len(windows)} windows "
                             f"for {self.plan.n_shards} slabs")
        lanes = self.plan.shard_capacity + 2 * self.plan.pairs_halo_capacity
        for s, (win, dev) in enumerate(zip(windows, self.devices)):
            want = pairs_ops.PairList.init(lanes, self._grids[dev],
                                           self.pcfg, self.dtype, "meta")
            for f in dataclasses.fields(want):
                got = getattr(win.plist, f.name).shape
                if got != getattr(want, f.name).shape:
                    raise ValueError(
                        f"resume_pair_window: slab {s}'s {f.name} of shape "
                        f"{tuple(got)}, this run's is "
                        f"{tuple(getattr(want, f.name).shape)}")
        self._windows = list(windows)
        self._window_left = int(window_left)
        self._last_state_out = state

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
        if state is not self._last_state_out:
            # A fresh or foreign state: the carried windows describe
            # another trajectory.
            self._windows = None
            self._window_left = 0
        # The flushes (K7) and K3 update a slab's measurements in place:
        # the run carries its own copies and never writes a tensor its
        # caller passed in.
        state = [(copy_tensors(st), valid.clone(), gid.clone())
                 for st, valid, gid in state]
        measure = [copy_tensors(m) for m in measure]
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
                uniforms = lambda s, i=i: draw(s, i)  # noqa: E731
                if self._pairs_mode:
                    rebuilt = self._window_left <= 0 or self._windows is None
                    if rebuilt:
                        state, measure, self._windows = self._pairs_rebuild(
                            slabs, state, measure)
                        self._window_left = self.pcfg.rebuild_interval
                    state, measure, metrics = self._pairs_step(
                        slabs, state, measure, uniforms, rebuilt)
                    self._window_left -= 1
                else:
                    state, measure, metrics = self._step(slabs, state,
                                                         measure, uniforms)
                steps.append(metrics)
            epoch = StepMetrics.stack(steps)
            epochs.append(epoch)
            if epoch_callback is not None:
                epoch_callback(epoch)
            step_index += len(steps)
        stacked = StepMetrics.concat(epochs) if epochs else None
        self._last_state_out = state
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
