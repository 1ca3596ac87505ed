"""The sweep and pairs engines: step functions and the host loop
``Simulation``.

Port of ``argon_monte_carlo_tpu.engine``.  One step of the sweep
(``narrowphase="sweep"``) is

    advance (drift -> wall pass -> recapture; K8 for the temperature pore)
    -> partner search (K2 + K9 on the cell grid, or K11 over all pairs)
    -> resolve_pairs (K10) -> recapture -> flush_hist (K7) -> counters

and one step of the Verlet pair-list engine (``narrowphase="pairs"``,
engine.py:310-472) is

    advance (K8) -> test_and_resolve (K3) -> recapture -> dirty mask ->
    one shared compaction (K6) and the dirty sub-compaction (K6) ->
    research_dirty (K4) -> flush_hist_compacted (K7) -> counters

(K3, K4 and K7's compacted entry update the step's own tensors in place,
as K10 and K7's dense entry do in the sweep)

with the rebuild (K2, K1, K5; ``ops/pairs.rebuild``) run by ``Simulation``
on the pre-drift positions at the start of every ``rebuild_interval``
window.  A plain Python loop over steps replaces the reference's
``lax.scan``; the host reads nothing back inside an epoch (counters,
cursors and metrics stay 0-d tensors on the device), so the card runs
ahead of the loop.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch

from . import kernels
from .config import cell_capacity_for, cell_size_for, pairs_cell_capacity_for
from .ops import collide
from .ops import measure as measure_ops
from .ops import pairs as pairs_ops
from .ops.compact import compact_indices
from .state import Measurements, ParticleState, StepMetrics


class WallLedger(NamedTuple):
    """Per-step wall-phase totals (Temperature_Pore_MC.py:685-687)."""

    momentum_z: torch.Tensor
    energy_hot: torch.Tensor
    energy_cold: torch.Tensor
    wall_hits: torch.Tensor
    errs: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Workload:
    """Everything workload-specific the engine needs.

    init_fn(generator, device) -> ParticleState
    wall_pass(state, prior_pos, measure, uniforms, cases=None)
        -> (state, measure, ledger)
    advance(state, measure, uniforms)
        -> (state, measure, ledger, recaptured, recap_w, speed_pre):
        the per-particle stage at the head of a step (drift, wall pass,
        post-wall recapture); a kernel where the workload has one
    advance_plain: the same, composed from the plain wall pass and
        recapture by ``advance_plain``
    post_pairs(state) -> (state, recaptured_count)
    audit_fn(state, prior) -> (10,) int32: the missed-case audit of the
        post-wall state against the pre-drift positions, or None where the
        workload has none (the cube); both ``advance`` functions take
        ``missed=``, a (10,) int32 tensor the audit's counts are added to
    """

    cfg: object
    init_fn: Callable
    wall_pass: Callable
    advance: Callable
    advance_plain: Callable
    post_pairs: Callable
    fluid_volume: float
    audit_fn: Optional[Callable] = None


def advance_plain(wall_pass: Callable, post_wall: Callable, dt: float,
                  audit_fn: Optional[Callable] = None) -> Callable:
    """The per-particle stage of a step as plain PyTorch, in the
    reference's order: the speed before the drift (the pairs engine's
    bump mask reads it), drift and path accrual (Open_Air_Cube_MC.py:
    179-187), the wall pass, the missed-case audit where ``missed`` is
    given (engine.py:162-165), the post-wall recapture and which particles
    it moved.  ``cases``, if a dict, receives each wall case's mask."""

    def advance(state, measure, uniforms, cases=None, missed=None):
        speed_pre = measure_ops.speed(state.vel)
        prior = state.pos
        state = dataclasses.replace(
            state,
            paths=measure_ops.accumulate_drift(state, dt),
            pos=state.pos + dt * state.vel,
        )
        state, measure, ledger = wall_pass(state, prior, measure, uniforms,
                                           cases)
        if missed is not None and audit_fn is not None:
            missed.add_(audit_fn(state, prior))
        pos_pre = state.pos
        state, recaptured = post_wall(state)
        recap_w = torch.any(state.pos != pos_pre, dim=-1)
        return state, measure, ledger, recaptured, recap_w, speed_pre

    return advance


def build_grids(workload: Workload, device):
    """Host-build the collision grid; returns (host_grid, device_grid), or
    (None, None) for the all-pairs broad phase.  The pairs engine's grid
    has the tighter capacity of ``pairs_cell_capacity_for``; the cube's
    grid is centred on the box (engine.py:61-102)."""
    cfg = workload.cfg
    eng = cfg.engine
    if eng.broadphase != "cells":
        return None, None
    physics = cfg.physics
    args = (eng, physics, cfg.num_molecules, workload.fluid_volume)
    cell_size = cell_size_for(*args)
    if eng.narrowphase == "pairs":
        capacity = pairs_cell_capacity_for(*args)
    else:
        capacity = cell_capacity_for(*args)
    geom = cfg.geometry
    if hasattr(geom, "total_height"):  # a pore
        host_grid = collide.grid_for_pore(geom, cell_size, capacity)
        center = (0.0, 0.0)
    else:  # the cube: a grid centred on the box
        host_grid = collide.grid_for_cube(geom, cell_size, capacity)
        center = (geom.lx / 2.0, geom.ly / 2.0)
    return host_grid, collide.DeviceGrid.from_grid(
        host_grid, eng.torch_dtype, device, center)


_NO_MISSED: dict = {}


def missed_counts(device, audits: bool):
    """A step's (sink, missed_cases): with the audit on, one fresh (10,)
    int32 zero tensor as both (``advance`` adds the counts to the sink);
    with it off, no sink and one zero tensor a device that nothing
    writes."""
    if audits:
        counts = torch.zeros(10, dtype=torch.int32, device=device)
        return counts, counts
    device = torch.device(device)
    if device not in _NO_MISSED:
        _NO_MISSED[device] = torch.zeros(10, dtype=torch.int32,
                                         device=device)
    return None, _NO_MISSED[device]


def _nonfinite(state: ParticleState, check: bool) -> torch.Tensor:
    if not check:
        return torch.zeros((), dtype=torch.int32, device=state.pos.device)
    return sum(torch.sum(~torch.isfinite(t), dtype=torch.int32)
               for t in (state.pos, state.vel, state.paths))


def make_step_fn(workload: Workload, grid: Optional[collide.DeviceGrid]):
    """The sweep's per-step function ``step(state, measure, uniforms,
    step_index) -> (state, measure, StepMetrics)``; the partner search is
    the broad phase's (engine.py:133-147)."""
    cfg = workload.cfg
    eng = cfg.engine
    physics = cfg.physics
    cr = physics.collision_range
    search_radius = cr + eng.skin
    hist_hi = eng.hist_range[1]
    audits = eng.debug_audits and workload.audit_fn is not None

    if eng.broadphase == "cells":
        def search(pos):
            _, table, pslot, overflow = collide.bin_and_table(pos, grid)
            return (collide.partner_sweep(pos, table, pslot, grid,
                                          search_radius), overflow)
    else:
        def search(pos):
            partner = collide.allpairs_partner_search(pos, search_radius,
                                                      eng.allpairs_tile)
            return partner, torch.zeros((), dtype=torch.int32,
                                        device=pos.device)

    def step(state: ParticleState, measure: Measurements,
             uniforms: torch.Tensor, step_index: int):
        # DRIFT, WALL CASES, the missed-case audit, then recapture.
        sink, missed = missed_counts(state.pos.device, audits)
        state, measure, ledger, oob_walls, _, _ = workload.advance(
            state, measure, uniforms, missed=sink)

        # PARTICLE-PARTICLE COLLISIONS: K10 adds the step's pairs to its
        # wall hits in place, the step's collision count.
        partner, overflow = search(state.pos)
        collisions = ledger.wall_hits.clone()
        state, measure, _ = collide.resolve_pairs(state, measure, partner,
                                                  cr, count=collisions)
        state, oob_pairs = workload.post_pairs(state)

        # HISTOGRAM FLUSH: every step is exact; a wider window stages
        # events across steps (one slot per particle), so the compaction
        # width scales with it.
        interval = eng.hist_flush_interval
        if interval <= 1:
            measure = measure_ops.flush_hist(measure, eng.num_bins, hist_hi)
        elif step_index % interval == 0:
            cap = min(state.num_particles,
                      measure_ops.FLUSH_CAPACITY * interval)
            measure = measure_ops.flush_hist(measure, eng.num_bins, hist_hi,
                                             capacity=cap)
        measure = dataclasses.replace(
            measure,
            overflow_count=measure.overflow_count + overflow,
            err_count=measure.err_count + ledger.errs,
            collision_count=measure.collision_count + collisions,
        )

        zero = torch.zeros((), dtype=torch.int32, device=state.pos.device)
        metrics = StepMetrics(
            momentum_z=ledger.momentum_z,
            energy_hot=ledger.energy_hot,
            energy_cold=ledger.energy_cold,
            collisions=collisions,
            wall_hits=ledger.wall_hits,
            oob_after_walls=oob_walls,
            oob_after_pairs=oob_pairs,
            missed_cases=missed,
            nonfinite=_nonfinite(state, eng.check_finite),
            rebuilt=zero, dirty_count=zero, latent_full=zero,
            teleports=zero, latent_research=zero,
        )
        return state, measure, metrics

    return step


def pairs_config_for(workload: Workload,
                     num_particles: Optional[int] = None
                     ) -> pairs_ops.PairConfig:
    """PairConfig sized from the physics (engine.py:227-307).

    lambda(K) = density * 4/3 pi (cr + 2 v_mean K dt)^3 is the expected
    in-reach candidate count per particle at rebuild; the expected
    cell-table spills at the grid's capacity (each spilled particle stays
    hot for the window) widen the re-search budget.  ``num_particles``
    overrides the population the capacities are sized for (the z-slab
    engine passes a slab's local and ghost lane count; the density, and so
    lambda, is the whole run's).  Raises ValueError for a workload no top_k
    emission can cover.
    """
    cfg = workload.cfg
    eng = cfg.engine
    physics = cfg.physics
    k = eng.rebuild_interval
    n = cfg.num_molecules
    n_sized = n if num_particles is None else num_particles
    density = n / workload.fluid_volume
    radius = physics.collision_range + 2.0 * physics.v_mean * k * cfg.dt
    lam = density * (4.0 / 3.0) * math.pi * radius**3
    cap_cells = pairs_cell_capacity_for(eng, physics, n,
                                        workload.fluid_volume)
    cs = cell_size_for(eng, physics, n, workload.fluid_volume)
    occ = max(density * cs**3, 1e-9)
    # Log-space Poisson pmf, summed occ + 10 sqrt(occ) terms past the
    # capacity.
    e_spill_per_cell = 0.0
    log_p = -occ
    j_hi = max(cap_cells + 60, int(occ + 10.0 * math.sqrt(occ)) + 2)
    for j in range(1, j_hi):
        log_p += math.log(occ) - math.log(j)
        if j > cap_cells:
            e_spill_per_cell += (j - cap_cells) * math.exp(log_p)
    e_spill = (n_sized / max(occ, 1e-9)) * e_spill_per_cell
    spill_hot = int(math.ceil(1.5 * e_spill))
    pcfg = pairs_ops.default_pair_config(n_sized, k, pair_expectation=lam,
                                         spill_hot=spill_hot)
    # The emission is one-sided: lambda/2 expected emissions per particle
    # against the top_k budget.
    if lam / 2.0 > 0.6 * pcfg.top_k:
        raise ValueError(
            f"narrowphase='pairs' cannot cover this workload: expected "
            f"in-reach candidates/particle lambda(K={k}) = {lam:.1f} "
            f"exceeds the top-{pcfg.top_k} emission budget (per-step "
            f"drift "
            f"{2 * physics.v_mean * cfg.dt / physics.collision_range:.1f} "
            f"collision ranges). Reduce rebuild_interval or use "
            f"narrowphase='sweep'."
        )
    return pcfg


def shared_compaction(pending_mask: torch.Tensor, dirty: torch.Tensor,
                      research_capacity: int):
    """(shared_idx, dirty_idx, research_dropped) of a pairs step: one
    N-sized compaction (K6) of the lanes the flush or the re-search needs,
    shared by both, then the dirty ones among it (K6 again), padded with
    n; ``research_dropped`` counts the dirty lanes beyond
    ``research_capacity`` (engine.py:407-441)."""
    n = dirty.shape[0]
    shared_cap = max(measure_ops.FLUSH_CAPACITY, n // 64)
    shared_idx = compact_indices(pending_mask | dirty, shared_cap, n)
    dirty_at = (shared_idx < n) & dirty[torch.clamp(shared_idx,
                                                    max=n - 1).long()]
    dsel = compact_indices(dirty_at, research_capacity, shared_cap)
    dirty_idx = torch.where(
        dsel < shared_cap,
        shared_idx[torch.clamp(dsel, max=shared_cap - 1).long()], n)
    research_dropped = (torch.sum(dirty, dtype=torch.int32)
                        - torch.sum(dirty_idx < n, dtype=torch.int32))
    return shared_idx, dirty_idx, research_dropped


def make_pairs_step_fn(workload: Workload, grid: collide.DeviceGrid,
                       pcfg: pairs_ops.PairConfig):
    """The pairs engine's per-step function ``step(state, measure, plist,
    uniforms, step_index, rebuilt) -> (state, measure, plist,
    StepMetrics)``, in the order of the reference's make_pairs_step_fn.
    The rebuild is not part of the step (``Simulation`` runs it)."""
    cfg = workload.cfg
    eng = cfg.engine
    dt = cfg.dt
    cr = cfg.physics.collision_range
    hist_hi = eng.hist_range[1]
    audits = eng.debug_audits and workload.audit_fn is not None

    def step(state: ParticleState, measure: Measurements,
             plist: pairs_ops.PairList, uniforms: torch.Tensor,
             step_index: int, rebuilt: bool):
        dev = state.pos.device
        # DRIFT, WALL CASES, the missed-case audit, then recapture (which
        # particles it moved go hot).
        sink, missed = missed_counts(dev, audits)
        state, measure, ledger, oob_walls, recap_w, speed_pre = (
            workload.advance(state, measure, uniforms, missed=sink))

        # PARTICLE-PARTICLE COLLISIONS on the listed pairs, in place on
        # the state and the staging.
        state, measure, pair_collisions, collided = (
            pairs_ops.test_and_resolve(state, measure, plist.a, plist.b, cr,
                                       pcfg.event_capacity))
        # post_pairs returns new tensors where it moves a particle (every
        # workload's does), so pos_pre still holds the positions before it;
        # an in-place post_pairs would make recap_p all False.
        pos_pre = state.pos
        state, oob_pairs = workload.post_pairs(state)
        recap_p = torch.any(state.pos != pos_pre, dim=-1)

        # DIRTY RE-SEARCH: speed changed, collided, teleported (hot for
        # the rest of the window) or queued at the rebuild (pending1).
        bump = (measure_ops.speed(state.vel) != speed_pre) | collided
        hot = plist.hot | recap_w | recap_p
        latent_full = torch.sum(plist.pending1, dtype=torch.int32)
        dirty = bump | hot | plist.pending1
        shared_idx, dirty_idx, research_dropped = shared_compaction(
            measure.pending_mask, dirty, pcfg.research_capacity)
        plist = dataclasses.replace(plist, hot=hot)
        # In place: the list is this step's alone (``hot`` was made above,
        # the rest is the Simulation's carried list, replaced by the one
        # returned here).
        plist, research_lost, latent_per = pairs_ops.research_dirty(
            state, plist, dirty_idx, bump, grid, pcfg, cr, dt)
        force = research_lost | (research_dropped > 0)
        plist = dataclasses.replace(
            plist,
            pending1=torch.zeros_like(plist.pending1),
            age=torch.where(force, pairs_ops.INT_BIG, plist.age + 1),
        )

        # In place; shared_idx is ascending, as the flush requires.
        measure = measure_ops.flush_hist_compacted(measure, shared_idx,
                                                   eng.num_bins, hist_hi)
        measure = dataclasses.replace(
            measure,
            overflow_count=(measure.overflow_count + plist.overflow
                            + research_dropped),
            hot_spill_count=measure.hot_spill_count + plist.spill,
            err_count=measure.err_count + ledger.errs,
            collision_count=measure.collision_count + ledger.wall_hits,
        )
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        plist = dataclasses.replace(plist, overflow=zero, spill=zero)

        metrics = StepMetrics(
            momentum_z=ledger.momentum_z,
            energy_hot=ledger.energy_hot,
            energy_cold=ledger.energy_cold,
            collisions=pair_collisions + ledger.wall_hits,
            wall_hits=ledger.wall_hits,
            oob_after_walls=oob_walls,
            oob_after_pairs=oob_pairs,
            missed_cases=missed,
            nonfinite=_nonfinite(state, eng.check_finite),
            rebuilt=torch.full((), int(rebuilt), dtype=torch.int32,
                               device=dev),
            dirty_count=torch.sum(dirty, dtype=torch.int32),
            latent_full=latent_full,
            teleports=torch.sum(recap_w | recap_p, dtype=torch.int32),
            latent_research=torch.sum(latent_per, dtype=torch.int32),
        )
        return state, measure, plist, metrics

    return step


def copy_tensors(obj):
    """A dataclass of tensors with every tensor cloned (None stays)."""
    if obj is None:
        return None
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).clone()
        for f in dataclasses.fields(obj)})


class Simulation:
    """Host loop: init once, run epochs of steps on ``device``.

    Every random draw comes from one ``torch.Generator`` seeded from the
    config's seed: first the initial state, then one (N, 2) block of
    uniforms per step.  ``run(draw=...)`` replaces the per-step draw, so a
    test can feed the JAX reference's uniforms and compare trajectories.

    In pairs mode the Simulation also carries the pair list and the steps
    left in its window across epochs and runs: it rebuilds on the pre-drift
    positions when the window is used up, and drops the list when ``run``
    gets a state other than the one it last returned (engine.py:494-814).

    The steps update the state and the measurements in place (the pairs
    step's K3 and K7's compacted entry, the sweep's and the cube's K10 and
    K7), so
    ``run`` copies the state and measurements it is handed once on entry
    and carries its own copies: it never writes a tensor its caller passed
    in.
    """

    def __init__(self, workload: Workload, device="cuda"):
        self.workload = workload
        self.cfg = workload.cfg
        self.device = torch.device(device)
        kernels.require_float32(self.cfg.engine.dtype, [self.device])
        self.host_grid, self.grid = build_grids(workload, self.device)
        self._pairs_mode = self.cfg.engine.narrowphase == "pairs"
        self._plist = None
        self._window_left = 0
        self._last_state_out = None
        if self._pairs_mode:
            self.pcfg = pairs_config_for(workload)
            self._step = make_pairs_step_fn(workload, self.grid, self.pcfg)
        else:
            self._step = make_step_fn(workload, self.grid)

    def init(self, seed: Optional[int] = None):
        """(state, measure, generator) for a fresh run; the generator has
        drawn the initial state and goes on to draw the steps."""
        seed = self.cfg.seed if seed is None else seed
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        state = self.workload.init_fn(gen, self.device)
        measure = Measurements.zeros(
            self.cfg.engine.num_bins, self.cfg.engine.torch_dtype,
            num_particles=state.num_particles, device=self.device,
        )
        return state, measure, gen

    def rebuild(self, state: ParticleState) -> None:
        """Rebuild the pair list on ``state`` and start a new window."""
        if self._plist is None:
            self._plist = pairs_ops.PairList.init(
                state.num_particles, self.grid, self.pcfg,
                self.cfg.engine.torch_dtype, self.device)
        self._plist = pairs_ops.rebuild(
            state, self.grid, self.pcfg, self.cfg.physics.collision_range,
            self.cfg.dt, self._plist)
        self._window_left = self.pcfg.rebuild_interval

    def pair_window(self):
        """(the carried pair list, steps left in its window) for a
        checkpoint, or None (the sweep, or no window open)."""
        if not self._pairs_mode or self._plist is None:
            return None
        return self._plist, self._window_left

    def resume_pair_window(self, state: ParticleState,
                           plist: pairs_ops.PairList, window_left: int):
        """Carry ``plist``, with ``window_left`` steps left in its window,
        into the next ``run`` from ``state``, as if this Simulation had
        returned that state: a run resumed from a checkpoint then rebuilds
        on the uninterrupted run's steps.  (A rebuild at the resume step
        instead is trajectory-neutral only while no one-step latency --
        a full emission, a table spill -- falls in the window.)"""
        if not self._pairs_mode:
            raise ValueError("resume_pair_window: narrowphase='sweep' "
                             "carries no pair list")
        want = pairs_ops.PairList.init(
            state.num_particles, self.grid, self.pcfg,
            self.cfg.engine.torch_dtype, "meta")
        for f in dataclasses.fields(plist):
            got = getattr(plist, f.name)
            if got.shape != getattr(want, f.name).shape:
                raise ValueError(
                    f"resume_pair_window: {f.name} of shape "
                    f"{tuple(got.shape)}, this run's is "
                    f"{tuple(getattr(want, f.name).shape)}")
        self._plist = plist
        self._window_left = int(window_left)
        self._last_state_out = state

    def _pairs_step(self, state, measure, uniforms, step_index):
        rebuilt = self._window_left <= 0
        if rebuilt:
            self.rebuild(state)
        state, measure, self._plist, metrics = self._step(
            state, measure, self._plist, uniforms, step_index, rebuilt)
        self._window_left -= 1
        return state, measure, metrics

    def run(self, num_steps: Optional[int] = None, seed=None, state=None,
            measure=None, generator=None, start_step: int = 0,
            draw: Optional[Callable[[int], torch.Tensor]] = None,
            epoch_callback=None):
        """Run ``num_steps`` steps; returns (state, measure, StepMetrics of
        (num_steps,) tensors, or None for zero steps).

        ``draw(step_index)`` supplies each step's (N, 2) uniforms; by
        default they come from ``generator``.  ``epoch_callback(metrics)``
        is called after each epoch with that epoch's metrics (still on the
        device; the call does not synchronise).
        """
        if num_steps is None:
            num_steps = self.cfg.num_timesteps
        if state is None:
            state, measure, generator = self.init(seed)
        if state is not self._last_state_out:
            # A fresh or foreign state: the carried pair list describes
            # another trajectory.
            self._plist = None
            self._window_left = 0
        state, measure = copy_tensors(state), copy_tensors(measure)
        if draw is None:
            if generator is None:
                raise ValueError("pass the generator that init() returned, "
                                 "or a draw function")
            n = state.num_particles
            dtype = self.cfg.engine.torch_dtype

            def draw(_step_index):
                return torch.rand((n, 2), generator=generator, dtype=dtype,
                                  device=self.device)

        step = self._pairs_step if self._pairs_mode else self._step
        epochs = []
        spe = self.cfg.engine.steps_per_epoch
        step_index = start_step
        end = start_step + num_steps
        while step_index < end:
            steps = []
            for i in range(step_index, min(step_index + spe, end)):
                state, measure, metrics = step(state, measure, draw(i), i)
                steps.append(metrics)
            epoch = StepMetrics.stack(steps)
            epochs.append(epoch)
            if epoch_callback is not None:
                epoch_callback(epoch)
            step_index += len(steps)
        stacked = StepMetrics.concat(epochs) if epochs else None
        self._last_state_out = state
        return state, measure, stacked

    @staticmethod
    def finalize_measure(measure: Measurements) -> Measurements:
        """Global accumulator totals (identity on one device)."""
        return measure
