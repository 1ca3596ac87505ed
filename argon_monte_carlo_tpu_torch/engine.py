"""The sweep and pairs engines: step functions and the host loop
``Simulation``.

Port of ``argon_monte_carlo_tpu.engine``.  One step of the sweep
(``narrowphase="sweep"``) is

    advance (drift -> wall pass -> recapture; K8 for the temperature pore)
    -> partner search (K2 + K9 on the cell grid, or K11 over all pairs)
    -> resolve_pairs (K10) -> recapture -> flush_hist (K7) -> counters

and one step of the Verlet pair-list engine (``narrowphase="pairs"``,
engine.py:310-472) is

    advance (K8) -> test_and_resolve (K3) -> recapture and dirty masks
    (K13 for the temperature pore) -> one shared compaction (K6) and the
    dirty sub-compaction (K6) -> research_dirty (K4) ->
    flush_hist_compacted (K7) -> counters

(K8, K3, K13, K4 and K7's compacted entry update the step's own tensors
in place, as K8, K10 and K7's dense entry do in the sweep)

with the rebuild (K2, K1, K5; ``ops/pairs.rebuild``) run by ``Simulation``
on the pre-drift positions at the start of every ``rebuild_interval``
window.  A plain Python loop over steps replaces the reference's
``lax.scan``; the host reads nothing back inside an epoch (counters,
cursors and metrics stay 0-d tensors on the device), so the card runs
ahead of the loop.  Each epoch, rebuild, step and stage of a step is a
span of ``trace`` while a torch profiler records.

The pairs step on a CUDA device is replayed from two CUDA graphs instead
(``StepGraphs``; ``replays_steps`` says when), unless a torch profiler
records: a profiled run takes the loop, whose spans the traces read.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from collections import Counter
from typing import Callable, NamedTuple, Optional

import torch

from . import kernels, trace
from .config import cell_capacity_for, cell_size_for, pairs_cell_capacity_for
from .ops import collide
from .ops import measure as measure_ops
from .ops import pairs as pairs_ops
from .ops import post_pairs as post_pairs_ops
from .ops.compact import compact_indices
from .state import Measurements, ParticleState, StepMetrics
from .trace import span


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
    post_pairs_stage(state, measure, plist, speed_pre, collided, recap_w)
        -> ops.post_pairs.PostPairs: the pairs step's recapture and dirty
        masks where the workload has a kernel for them (K13, the
        temperature pore), or None: the pairs step then runs
        ``post_pairs_plain`` with ``post_pairs``
    """

    cfg: object
    init_fn: Callable
    wall_pass: Callable
    advance: Callable
    advance_plain: Callable
    post_pairs: Callable
    fluid_volume: float
    audit_fn: Optional[Callable] = None
    post_pairs_stage: Optional[Callable] = None


def advance_plain(wall_pass: Callable, post_wall: Callable, dt: float,
                  audit_fn: Optional[Callable] = None) -> Callable:
    """The per-particle stage of a step as plain PyTorch, in the
    reference's order: the speed before the drift (the pairs engine's
    bump mask reads it), drift and path accrual (Open_Air_Cube_MC.py:
    179-187), the wall pass, the missed-case audit where ``missed`` is
    given (engine.py:162-165), the post-wall recapture and which particles
    it moved.  ``cases``, if a dict, receives each wall case's mask.
    Everything after the speed is the span ``amc/step/walls``: the job K8
    does in one pass for the temperature pore, and K14, whose launch
    records the same span, for the specular pore."""

    def advance(state, measure, uniforms, cases=None, missed=None):
        speed_pre = measure_ops.speed(state.vel)
        with span("amc/step/walls"):
            prior = state.pos
            state = dataclasses.replace(
                state,
                paths=measure_ops.accumulate_drift(state, dt),
                pos=state.pos + dt * state.vel,
            )
            state, measure, ledger = wall_pass(state, prior, measure,
                                               uniforms, cases)
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
    grid is centred on the box (engine.py:61-102).  The build is the span
    ``amc/grid``."""
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
    with span("amc/grid"):
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


def _nonfinite(state: ParticleState, check: bool,
               valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The state's non-finite elements (0-d int32), over the ``valid``
    lanes where given (a z-slab's, shard.py:253-267); zero unchecked."""
    if not check:
        return torch.zeros((), dtype=torch.int32, device=state.pos.device)

    def count(t):
        bad = ~torch.isfinite(t)
        return torch.sum(bad if valid is None else bad & valid[:, None],
                         dtype=torch.int32)

    return sum(count(t) for t in (state.pos, state.vel, state.paths))


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
        with span("amc/step"):
            return stages(state, measure, uniforms, step_index)

    def stages(state, measure, uniforms, step_index):
        # DRIFT, WALL CASES, the missed-case audit, then recapture.
        with span("amc/step/advance"):
            sink, missed = missed_counts(state.pos.device, audits)
            state, measure, ledger, oob_walls, _, _ = workload.advance(
                state, measure, uniforms, missed=sink)

        # PARTICLE-PARTICLE COLLISIONS: K10 adds the step's pairs to its
        # wall hits in place, the step's collision count.
        with span("amc/step/search"):
            partner, overflow = search(state.pos)
        with span("amc/step/resolve"):
            collisions = ledger.wall_hits.clone()
            state, measure, _ = collide.resolve_pairs(
                state, measure, partner, cr, count=collisions)
        with span("amc/step/recapture"):
            state, oob_pairs = workload.post_pairs(state)

        # HISTOGRAM FLUSH: every step is exact; a wider window stages
        # events across steps (one slot per particle), so the compaction
        # width scales with it.
        with span("amc/step/flush"):
            interval = eng.hist_flush_interval
            if interval <= 1:
                measure = measure_ops.flush_hist(measure, eng.num_bins,
                                                 hist_hi)
            elif step_index % interval == 0:
                cap = min(state.num_particles,
                          measure_ops.FLUSH_CAPACITY * interval)
                measure = measure_ops.flush_hist(measure, eng.num_bins,
                                                 hist_hi, capacity=cap)

        with span("amc/step/counters"):
            measure = dataclasses.replace(
                measure,
                overflow_count=measure.overflow_count + overflow,
                err_count=measure.err_count + ledger.errs,
                collision_count=measure.collision_count + collisions,
            )
            zero = torch.zeros((), dtype=torch.int32,
                               device=state.pos.device)
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


def shared_compaction(shared: torch.Tensor, dirty: torch.Tensor,
                      dirty_count: torch.Tensor, research_capacity: int):
    """(shared_idx, dirty_idx, research_dropped) of a pairs step: one
    N-sized compaction (K6) of the lanes the flush or the re-search needs
    (``shared``, ``pending_mask | dirty``), shared by both, then the dirty
    ones among it (K6 again), padded with n; ``research_dropped`` counts
    the ``dirty_count`` dirty lanes beyond ``research_capacity``
    (engine.py:407-441)."""
    n = dirty.shape[0]
    shared_cap = max(measure_ops.FLUSH_CAPACITY, n // 64)
    shared_idx = compact_indices(shared, shared_cap, n)
    dirty_at = (shared_idx < n) & dirty[torch.clamp(shared_idx,
                                                    max=n - 1).long()]
    dsel = compact_indices(dirty_at, research_capacity, shared_cap)
    dirty_idx = torch.where(
        dsel < shared_cap,
        shared_idx[torch.clamp(dsel, max=shared_cap - 1).long()], n)
    research_dropped = (dirty_count
                        - torch.sum(dirty_idx < n, dtype=torch.int32))
    return shared_idx, dirty_idx, research_dropped


def pairs_step_tail(post: post_pairs_ops.PostPairs, measure: Measurements,
                    ledger: WallLedger, grid: collide.DeviceGrid,
                    pcfg: pairs_ops.PairConfig, cfg,
                    ids: Optional[torch.Tensor] = None,
                    local: Optional[torch.Tensor] = None):
    """The pairs step after its post-pairs stage ``post``, on one card and
    on a z-slab alike: the shared compaction (K6 twice), the dirty lanes'
    re-search (K4) and the list's force/age, the compacted flush (K7c), the
    measure's counters and the list's cleared ``overflow`` and ``spill``.
    Returns (measure, plist, latent_research).  A slab passes its global
    ``ids`` (K4's "not itself") and its ``local`` lanes, the dirty ones of
    which ``latent_research`` counts.  K4 and K7c work in place: the list
    and the staging are the step's alone."""
    eng = cfg.engine
    cr = cfg.physics.collision_range
    state, plist = post.state, post.plist
    with span("amc/step/dirty"):
        shared_idx, dirty_idx, research_dropped = shared_compaction(
            post.shared, post.dirty, post.dirty_count,
            pcfg.research_capacity)
    with span("amc/step/research"):
        plist, research_lost, latent_per = pairs_ops.research_dirty(
            state, plist, dirty_idx, post.bump, grid, pcfg, cr, cfg.dt,
            ids=ids)
        force = research_lost | (research_dropped > 0)
        plist = dataclasses.replace(
            plist,
            age=torch.where(force, pairs_ops.INT_BIG, plist.age + 1),
        )

    # In place; shared_idx is ascending, as the flush requires.
    with span("amc/step/flush"):
        measure = measure_ops.flush_hist_compacted(
            measure, shared_idx, eng.num_bins, eng.hist_range[1])

    with span("amc/step/counters"):
        measure = dataclasses.replace(
            measure,
            overflow_count=(measure.overflow_count + plist.overflow
                            + research_dropped),
            hot_spill_count=measure.hot_spill_count + plist.spill,
            err_count=measure.err_count + ledger.errs,
            collision_count=measure.collision_count + ledger.wall_hits,
        )
        zero = torch.zeros((), dtype=torch.int32, device=state.pos.device)
        plist = dataclasses.replace(plist, overflow=zero, spill=zero)
        if local is not None:
            n = post.dirty.shape[0]
            counted = (dirty_idx < n) & local[torch.clamp(
                dirty_idx, max=n - 1).long()]
            latent_per = torch.where(counted, latent_per, 0)
        latent_research = torch.sum(latent_per, dtype=torch.int32)
    return measure, plist, latent_research


def make_pairs_step_fn(workload: Workload, grid: collide.DeviceGrid,
                       pcfg: pairs_ops.PairConfig):
    """The pairs engine's per-step function ``step(state, measure, plist,
    uniforms, step_index, rebuilt) -> (state, measure, plist,
    StepMetrics)``, in the order of the reference's make_pairs_step_fn.
    The rebuild is not part of the step (``Simulation`` runs it)."""
    cfg = workload.cfg
    eng = cfg.engine
    cr = cfg.physics.collision_range
    audits = eng.debug_audits and workload.audit_fn is not None
    post_pairs = workload.post_pairs_stage or functools.partial(
        post_pairs_ops.post_pairs_plain, workload.post_pairs)

    def step(state: ParticleState, measure: Measurements,
             plist: pairs_ops.PairList, uniforms: torch.Tensor,
             step_index: int, rebuilt: bool):
        with span("amc/step"):
            return stages(state, measure, plist, uniforms, rebuilt)

    def stages(state, measure, plist, uniforms, rebuilt):
        dev = state.pos.device
        # DRIFT, WALL CASES, the missed-case audit, then recapture (which
        # particles it moved go hot).
        with span("amc/step/advance"):
            sink, missed = missed_counts(dev, audits)
            state, measure, ledger, oob_walls, recap_w, speed_pre = (
                workload.advance(state, measure, uniforms, missed=sink))

        # PARTICLE-PARTICLE COLLISIONS on the listed pairs, in place on
        # the state and the staging.
        with span("amc/step/resolve"):
            state, measure, pair_collisions, collided = (
                pairs_ops.test_and_resolve(state, measure, plist.a, plist.b,
                                           cr, pcfg.event_capacity))
        # The post-pairs recapture, then the DIRTY masks: speed changed,
        # collided, teleported (hot for the rest of the window) or queued
        # at the rebuild (pending1, cleared for the next step); K13 in place
        # on the temperature pore's pos, hot and pending1.
        with span("amc/step/recapture"):
            post = post_pairs(state, measure, plist, speed_pre, collided,
                              recap_w)
        # In place: the list is this step's alone (the Simulation's carried
        # list, replaced by the one returned here).
        measure, plist, latent_research = pairs_step_tail(
            post, measure, ledger, grid, pcfg, cfg)
        state = post.state
        metrics = StepMetrics(
            momentum_z=ledger.momentum_z,
            energy_hot=ledger.energy_hot,
            energy_cold=ledger.energy_cold,
            collisions=pair_collisions + ledger.wall_hits,
            wall_hits=ledger.wall_hits,
            oob_after_walls=oob_walls,
            oob_after_pairs=post.oob_after_pairs,
            missed_cases=missed,
            nonfinite=_nonfinite(state, eng.check_finite),
            rebuilt=torch.full((), int(rebuilt), dtype=torch.int32,
                               device=dev),
            dirty_count=post.dirty_count,
            latent_full=post.latent_full,
            teleports=post.teleports,
            latent_research=latent_research,
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


def copy_into(static, obj) -> int:
    """Copy every tensor of ``obj`` into the same field of ``static`` (a
    dataclass of tensors of the same class and shapes) in place; a field
    that is the same tensor in both is left alone.  Returns the bytes
    copied."""
    copied = 0
    for f in dataclasses.fields(obj):
        dst, src = getattr(static, f.name), getattr(obj, f.name)
        if dst.data_ptr() != src.data_ptr():
            dst.copy_(src)
            copied += dst.numel() * dst.element_size()
    return copied


# Device -> the stream every ``StepGraphs`` of the process runs its eager
# steps and captures on.  One a device: the kernels keep scratch for each
# stream they ever ran on (``ops/compact.stream_scratch``) and never free
# it, so a stream a ``Simulation`` would leave scratch behind each time.
_CAPTURE_STREAMS: dict = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device]


def replays_steps(narrowphase: str, device, profiling: bool) -> bool:
    """Whether ``Simulation.run`` replays its steps from CUDA graphs
    (``StepGraphs``): the pairs step on a CUDA device while no torch
    profiler records.  A profiled run takes the loop, whose spans and
    wrapped calls the traces attribute device work to (a replay runs none
    of them); the CPU, the sweep and the cube always take it."""
    return (narrowphase == "pairs" and torch.device(device).type == "cuda"
            and not profiling)


class StepGraphs:
    """The pairs step of one ``Simulation`` and particle count as two CUDA
    graphs: the step with the pair-list rebuild in front and the plain step
    (``step(rebuilt)``); the host keeps the window's count and picks.

    Their inputs live at fixed addresses: the run's carried ``state``,
    ``measure`` and ``plist`` (``load`` copies a run's into them), the
    step's (N, 2) ``uniforms``, and the rows of an epoch's ``StepMetrics``
    with a device-side ``cursor``.  The body (``run_body``) runs the step
    on them, copies each tensor the step made anew back into its input
    (``copy_into``; the kernels' in-place updates need none) and writes
    the step's metrics into row ``cursor``, so every tensor a replay makes
    is dead when it ends: the two graphs share one memory pool.  The body
    is ``body(state, measure, plist, uniforms, rebuilt, copy)``, with
    ``copy(static, obj)`` the copy it makes its own copies with (the new
    list at a rebuild).

    Each graph is captured at its first step after its body ran once
    eagerly on the capture stream (``capture_stream``), a real step of the
    run that makes the kernels' scratch kept for that stream
    (``ops/compact``) and the rows; the capture records the same launches
    without running them.  A replay adds the launches its graph recorded
    to ``kernels.launch_counts``.

    Three counters of the host, which no replay touches: ``capture_s``,
    the host seconds of the eager steps and the captures (each the span
    ``amc/capture``), summed; ``held_bytes``, set after each capture, the
    device bytes the replay holds: every tensor of the graphs' inputs (the
    carried state, measurements and list, the uniforms, the rows and the
    cursor) and the segments the captures reserved in the graphs' pool;
    ``copy_back_bytes``, rebuilt -> the bytes that body's copies copied,
    set each time it runs (the same at its eager step and its capture)."""

    def __init__(self, body: Callable, state: ParticleState,
                 steps_per_epoch: int):
        self._body = body
        self.n = state.num_particles
        self.device = state.pos.device
        self.state = self.measure = self.plist = None
        self.uniforms = torch.empty((self.n, 2), dtype=state.pos.dtype,
                                    device=self.device)
        self.cursor = torch.zeros(1, dtype=torch.int64, device=self.device)
        self._spe = steps_per_epoch
        self._rows = None      # dtype -> (steps_per_epoch, width) tensor
        self._layout = None    # (field, dtype, column, width, shape)
        self._pool = None
        self._graphs: dict = {}  # rebuilt -> (CUDAGraph, launches recorded)
        self._warm: set = set()
        self.capture_s = 0.0
        self.held_bytes: Optional[int] = None
        self.copy_back_bytes: dict = {}
        self._copied = 0

    def load(self, state, measure, plist) -> None:
        """Carry ``state``, ``measure`` and ``plist`` into the graphs'
        inputs (copies; the first load makes them)."""
        if self.state is None:
            self.state, self.measure, self.plist = (
                copy_tensors(o) for o in (state, measure, plist))
            return
        for static, obj in ((self.state, state), (self.measure, measure),
                            (self.plist, plist)):
            copy_into(static, obj)

    def run_body(self, rebuilt: bool) -> None:
        """One step on the graphs' inputs, as captured."""
        self._copied = 0
        state, measure, plist, metrics = self._body(
            self.state, self.measure, self.plist, self.uniforms, rebuilt,
            self._copy_back)
        for static, obj in ((self.state, state), (self.measure, measure),
                            (self.plist, plist)):
            self._copy_back(static, obj)
        self.copy_back_bytes[rebuilt] = self._copied
        self._write_row(metrics)

    def _copy_back(self, static, obj) -> None:
        self._copied += copy_into(static, obj)

    def _write_row(self, metrics: StepMetrics) -> None:
        values = [(f.name, getattr(metrics, f.name))
                  for f in dataclasses.fields(metrics)]
        if self._rows is None:
            widths, self._layout = Counter(), []
            for name, t in values:
                self._layout.append((name, t.dtype, widths[t.dtype],
                                     t.numel(), tuple(t.shape)))
                widths[t.dtype] += t.numel()
            self._rows = {dt: torch.zeros((self._spe, w), dtype=dt,
                                          device=self.device)
                          for dt, w in widths.items()}
        for dt, rows in self._rows.items():
            row = torch.cat([t.reshape(1, -1) for _, t in values
                             if t.dtype == dt], dim=1)
            rows.index_copy_(0, self.cursor, row)
        self.cursor.add_(1)

    def epoch_metrics(self, steps: int) -> StepMetrics:
        """The ``steps`` rows written since the last call, as the caller's
        own ``StepMetrics`` of (steps,) tensors; the cursor goes back to 0."""
        out = {name: torch.clone(
                   self._rows[dt][:steps, col:col + width].reshape(
                       steps, *shape), memory_format=torch.contiguous_format)
               for name, dt, col, width, shape in self._layout}
        self.cursor.zero_()
        return StepMetrics(**out)

    def step(self, rebuilt: bool) -> bool:
        """One step on the card: a replay of its graph (True), or, before
        that graph is captured, its body run eagerly on the capture stream
        (False)."""
        graph = self._graphs.get(rebuilt)
        if graph is None and rebuilt in self._warm:
            t = time.perf_counter()
            with span("amc/capture"):
                graph = self._graphs[rebuilt] = self._capture(rebuilt)
            self.capture_s += time.perf_counter() - t
            self.held_bytes = self._held()
        if graph is None:
            t = time.perf_counter()
            with span("amc/capture"):
                side = capture_stream(self.device)
                current = torch.cuda.current_stream(self.device)
                side.wait_stream(current)
                with torch.cuda.stream(side):
                    self.run_body(rebuilt)
                current.wait_stream(side)
            self.capture_s += time.perf_counter() - t
            self._warm.add(rebuilt)
            return False
        graph[0].replay()
        kernels.launch_counts.update(graph[1])
        return True

    def _capture(self, rebuilt: bool):
        before = kernels.launch_counts.copy()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool,
                              stream=capture_stream(self.device)):
            self.run_body(rebuilt)
        recorded = kernels.launch_counts - before
        kernels.launch_counts.clear()
        kernels.launch_counts.update(before)
        if self._pool is None:
            self._pool = graph.pool()
        return graph, recorded

    def _held(self) -> int:
        """The bytes of the graphs' inputs and of their pool's segments."""
        inputs = {t.untyped_storage().data_ptr():
                  t.untyped_storage().nbytes() for t in (
            [getattr(o, f.name) for o in (self.state, self.measure,
                                          self.plist)
             for f in dataclasses.fields(o)]
            + [self.uniforms, self.cursor, *self._rows.values()])}
        pool = tuple(self._pool)
        segments = sum(seg["total_size"]
                       for seg in torch.cuda.memory_snapshot()
                       if tuple(seg.get("segment_pool_id", ())) == pool)
        return sum(inputs.values()) + segments


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

    The steps update the state and the measurements in place (K8 in both
    pores' steps, the pairs step's K3, K13 and K7's compacted entry, the
    sweep's and the cube's K10 and K7), so
    ``run`` copies the state and measurements it is handed once on entry
    and carries its own copies: it never writes a tensor its caller passed
    in.

    Where ``replays_steps`` holds, ``run`` replays the steps from the
    ``StepGraphs`` of this Simulation and particle count, made at the first
    such run: the same kernels in the same order, so the same results as
    the loop.  ``replayed_steps`` and ``looped_steps`` count the steps of
    each kind (a step run eagerly before its graph is captured is looped).

    Set-up's host counters: ``grid_build_s``, the host seconds of
    ``build_grids`` (None without a grid); ``capture_s`` and
    ``graph_held_bytes``, the ``StepGraphs``' ``capture_s`` and
    ``held_bytes`` (None before a run makes the graphs); and
    ``copy_back_bytes_per_step``, the bytes a replayed step copies back
    into the graphs' inputs, the mean over a window: (the plain step's x
    (K - 1) + the rebuilding step's) / K, K = ``rebuild_interval`` (None
    before both steps ran).
    """

    def __init__(self, workload: Workload, device="cuda"):
        self.workload = workload
        self.cfg = workload.cfg
        self.device = torch.device(device)
        kernels.require_float32(self.cfg.engine.dtype, [self.device])
        t = time.perf_counter()
        self.host_grid, self.grid = build_grids(workload, self.device)
        self.grid_build_s = (None if self.grid is None
                             else time.perf_counter() - t)
        self._pairs_mode = self.cfg.engine.narrowphase == "pairs"
        self._plist = None
        self._window_left = 0
        self._last_state_out = None
        self._graphs: Optional[StepGraphs] = None
        self.replayed_steps = 0
        self.looped_steps = 0
        if self._pairs_mode:
            self.pcfg = pairs_config_for(workload)
            self._step = make_pairs_step_fn(workload, self.grid, self.pcfg)
        else:
            self._step = make_step_fn(workload, self.grid)

    @property
    def capture_s(self) -> Optional[float]:
        return None if self._graphs is None else self._graphs.capture_s

    @property
    def graph_held_bytes(self) -> Optional[int]:
        return None if self._graphs is None else self._graphs.held_bytes

    @property
    def copy_back_bytes_per_step(self) -> Optional[float]:
        copied = {} if self._graphs is None else self._graphs.copy_back_bytes
        if True not in copied:
            return None
        k = self.pcfg.rebuild_interval
        if k > 1 and False not in copied:
            return None
        return (copied.get(False, 0) * (k - 1) + copied[True]) / k

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

    def _carried_list(self, n: int) -> pairs_ops.PairList:
        """The carried pair list, an empty one where none is carried."""
        if self._plist is None:
            self._plist = pairs_ops.PairList.init(
                n, self.grid, self.pcfg, self.cfg.engine.torch_dtype,
                self.device)
        return self._plist

    def rebuild(self, state: ParticleState) -> None:
        """Rebuild the pair list on ``state`` and start a new window."""
        with span("amc/rebuild"):
            self._plist = pairs_ops.rebuild(
                state, self.grid, self.pcfg,
                self.cfg.physics.collision_range, self.cfg.dt,
                self._carried_list(state.num_particles))
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

    def _step_graphs(self, state: ParticleState) -> StepGraphs:
        if self._graphs is None or self._graphs.n != state.num_particles:
            step, grid, pcfg = self._step, self.grid, self.pcfg
            cr, dt = self.cfg.physics.collision_range, self.cfg.dt

            def body(state, measure, plist, uniforms, rebuilt: bool, copy):
                # What a graph records: the rebuild where the window begins,
                # copied into the carried list at once, so that the old and
                # the new list are not both held through the step (as the
                # loop holds neither); then the step, which reads no step
                # index.  No reference to this Simulation: no cycle.
                if rebuilt:
                    copy(plist, pairs_ops.rebuild(state, grid, pcfg, cr, dt,
                                                  plist))
                return step(state, measure, plist, uniforms, None, rebuilt)

            self._graphs = StepGraphs(body, state,
                                      self.cfg.engine.steps_per_epoch)
        return self._graphs

    def _replayed_epoch(self, graphs: StepGraphs, fill, first: int,
                        count: int) -> StepMetrics:
        for i in range(first, first + count):
            fill(i)
            rebuilt = self._window_left <= 0
            if rebuilt:
                self._window_left = self.pcfg.rebuild_interval
            if graphs.step(rebuilt):
                self.replayed_steps += 1
            else:
                self.looped_steps += 1
            self._window_left -= 1
        return graphs.epoch_metrics(count)

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
        if draw is None and generator is None:
            raise ValueError("pass the generator that init() returned, "
                             "or a draw function")
        n = state.num_particles
        graphs = None
        if replays_steps(self.cfg.engine.narrowphase, state.pos.device,
                         trace.profiling()):
            graphs = self._step_graphs(state)
            graphs.load(state, measure, self._carried_list(n))
            self._plist = graphs.plist
            if draw is None:
                def fill(_step_index):
                    graphs.uniforms.uniform_(generator=generator)
            else:
                def fill(step_index):
                    graphs.uniforms.copy_(draw(step_index))
        else:
            state, measure = copy_tensors(state), copy_tensors(measure)
            if draw is None:
                dtype = self.cfg.engine.torch_dtype

                def draw(_step_index):
                    return torch.rand((n, 2), generator=generator,
                                      dtype=dtype, device=self.device)

        step = self._pairs_step if self._pairs_mode else self._step
        epochs = []
        spe = self.cfg.engine.steps_per_epoch
        step_index = start_step
        end = start_step + num_steps
        while step_index < end:
            count = min(spe, end - step_index)
            with span("amc/epoch"):
                if graphs is not None:
                    epoch = self._replayed_epoch(graphs, fill, step_index,
                                                 count)
                else:
                    steps = []
                    for i in range(step_index, step_index + count):
                        state, measure, metrics = step(state, measure,
                                                       draw(i), i)
                        steps.append(metrics)
                    self.looped_steps += count
                    epoch = StepMetrics.stack(steps)
            epochs.append(epoch)
            if epoch_callback is not None:
                epoch_callback(epoch)
            step_index += count
        stacked = StepMetrics.concat(epochs) if epochs else None
        if graphs is not None:
            # The graphs' inputs are overwritten by the next run: the caller
            # gets copies of its own.
            state = copy_tensors(graphs.state)
            measure = copy_tensors(graphs.measure)
        self._last_state_out = state
        return state, measure, stacked

    @staticmethod
    def finalize_measure(measure: Measurements) -> Measurements:
        """Global accumulator totals (identity on one device)."""
        return measure
