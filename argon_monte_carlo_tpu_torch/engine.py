"""The sweep engine: step function and the host loop ``Simulation``.

Port of ``argon_monte_carlo_tpu.engine`` for ``narrowphase="sweep"``.  One
step is

    drift -> wall pass -> recapture -> bin_and_table (K2) ->
    partner_sweep (K9) -> resolve_pairs (K10) -> recapture ->
    flush_hist (K7) -> counters

A plain Python loop over steps replaces the reference's ``lax.scan``; the
host reads nothing back inside an epoch (counters and metrics stay 0-d
tensors on the device), so the card runs ahead of the loop.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from .config import cell_capacity_for, cell_size_for
from .ops import collide
from .ops import measure as measure_ops
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
    wall_pass(state, prior_pos, measure, uniforms) -> (state, measure, ledger)
    post_wall / post_pairs(state) -> (state, recaptured_count)
    """

    cfg: object
    init_fn: Callable
    wall_pass: Callable
    post_wall: Callable
    post_pairs: Callable
    fluid_volume: float


def build_grids(workload: Workload, device):
    """Host-build the collision grid; returns (host_grid, device_grid)."""
    cfg = workload.cfg
    eng = cfg.engine
    physics = cfg.physics
    cell_size = cell_size_for(eng, physics, cfg.num_molecules,
                              workload.fluid_volume)
    capacity = cell_capacity_for(eng, physics, cfg.num_molecules,
                                 workload.fluid_volume)
    host_grid = collide.grid_for_pore(cfg.geometry, cell_size, capacity)
    return host_grid, collide.DeviceGrid.from_grid(host_grid, eng.torch_dtype,
                                                   device)


def make_step_fn(workload: Workload, grid: collide.DeviceGrid):
    """The per-step function ``step(state, measure, uniforms, step_index)
    -> (state, measure, StepMetrics)``."""
    cfg = workload.cfg
    eng = cfg.engine
    physics = cfg.physics
    dt = cfg.dt
    cr = physics.collision_range
    search_radius = cr + eng.skin
    hist_hi = eng.hist_range[1]

    def step(state: ParticleState, measure: Measurements,
             uniforms: torch.Tensor, step_index: int):
        # DRIFT (Open_Air_Cube_MC.py:179-187) + path accrual.
        prior = state.pos
        state = dataclasses.replace(
            state,
            paths=measure_ops.accumulate_drift(state, dt),
            pos=state.pos + dt * state.vel,
        )

        # WALL CASES, then recapture.
        state, measure, ledger = workload.wall_pass(state, prior, measure,
                                                    uniforms)
        state, oob_walls = workload.post_wall(state)

        # PARTICLE-PARTICLE COLLISIONS.
        _, table, pslot, overflow = collide.bin_and_table(state.pos, grid)
        partner = collide.partner_sweep(state.pos, table, pslot, grid,
                                        search_radius)
        state, measure, pair_collisions = collide.resolve_pairs(
            state, measure, partner, cr)
        measure = dataclasses.replace(
            measure,
            collision_count=measure.collision_count + pair_collisions)
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
            collision_count=measure.collision_count + ledger.wall_hits,
        )

        if eng.check_finite:
            nonfinite = sum(
                torch.sum(~torch.isfinite(t), dtype=torch.int32)
                for t in (state.pos, state.vel, state.paths))
        else:
            nonfinite = torch.zeros((), dtype=torch.int32,
                                    device=state.pos.device)
        metrics = StepMetrics(
            momentum_z=ledger.momentum_z,
            energy_hot=ledger.energy_hot,
            energy_cold=ledger.energy_cold,
            collisions=pair_collisions + ledger.wall_hits,
            wall_hits=ledger.wall_hits,
            oob_after_walls=oob_walls,
            oob_after_pairs=oob_pairs,
            nonfinite=nonfinite,
        )
        return state, measure, metrics

    return step


class Simulation:
    """Host loop: init once, run epochs of steps on ``device``.

    Every random draw comes from one ``torch.Generator`` seeded from the
    config's seed: first the initial state, then one (N, 2) block of
    uniforms per step.  ``run(draw=...)`` replaces the per-step draw, so a
    test can feed the JAX reference's uniforms and compare trajectories.
    """

    def __init__(self, workload: Workload, device="cuda"):
        self.workload = workload
        self.cfg = workload.cfg
        self.device = torch.device(device)
        self.host_grid, self.grid = build_grids(workload, self.device)
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
        if draw is None:
            if generator is None:
                raise ValueError("pass the generator that init() returned, "
                                 "or a draw function")
            n = state.num_particles
            dtype = self.cfg.engine.torch_dtype

            def draw(_step_index):
                return torch.rand((n, 2), generator=generator, dtype=dtype,
                                  device=self.device)

        epochs = []
        spe = self.cfg.engine.steps_per_epoch
        step_index = start_step
        end = start_step + num_steps
        while step_index < end:
            steps = []
            for i in range(step_index, min(step_index + spe, end)):
                state, measure, metrics = self._step(state, measure, draw(i),
                                                     i)
                steps.append(metrics)
            epoch = StepMetrics.stack(steps)
            epochs.append(epoch)
            if epoch_callback is not None:
                epoch_callback(epoch)
            step_index += len(steps)
        stacked = StepMetrics.concat(epochs) if epochs else None
        return state, measure, stacked

    @staticmethod
    def finalize_measure(measure: Measurements) -> Measurements:
        """Global accumulator totals (identity on one device)."""
        return measure
