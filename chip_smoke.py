#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each prints its lines; any failed check raises and the script
exits non-zero without a result line):

0. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
1. build the CUDA kernels from ``argon_monte_carlo_tpu_torch/kernels``
   (one ``nvcc`` process a source, all started together);
2. each kernel against its plain PyTorch version on the same tensors on the
   card, at the shapes of the 1M-particle temperature pore (the sweep's
   K2, K9, K10, K7; the pairs engine's K6, K1, K5, K3, K4 and K7's
   compacted entry), with both times;
3. the sweep slice and the pairs slice on the card against the same slices
   on the CPU (the plain versions, which the CPU tests hold to the JAX
   package) at 20k particles, 10 steps, from one state with one set of
   uniforms;
4. the pairs engine against the sweep engine on the card at 1M particles,
   100 steps, from one state with one set of uniforms;
5. the sweep slice: ``Simulation(make_workload(cfg), device="cuda")`` for
   300 steps at 1M particles, float32, its invariants, throughput, init
   time and peak memory, with the launch count of every kernel in that run;
6. the pairs slice (``narrowphase="pairs"``, ``rebuild_interval=8``) the
   same way, with the rebuild and step times of one window.

The last line is ``{"ok": true, "device": {...}}``.  There is no CPU path:
without CUDA the script stops before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

import argon_monte_carlo_tpu_torch as amt
from argon_monte_carlo_tpu_torch import kernels
from argon_monte_carlo_tpu_torch.engine import build_grids, pairs_config_for
from argon_monte_carlo_tpu_torch.init import init_pore
from argon_monte_carlo_tpu_torch.ops import collide, measure as measure_ops
from argon_monte_carlo_tpu_torch.ops import compact, oob
from argon_monte_carlo_tpu_torch.ops import pairs as pairs_ops
from argon_monte_carlo_tpu_torch.state import Measurements, StepMetrics

PARTICLES = 1_000_000
STEPS = 300
STEPS_PER_EPOCH = 100
SEED = 17
PAIRS = dict(narrowphase="pairs", rebuild_interval=8)

KERNELS = {
    "bin_and_table": dict(
        source="argon_monte_carlo_tpu_torch/kernels/csrc/bin_and_table.cu",
        replaces="argon_monte_carlo_tpu/ops/collide.py:355"),
    "partner_sweep": dict(
        source="argon_monte_carlo_tpu_torch/kernels/csrc/partner_sweep.cu",
        replaces="7e76fb0^:argon_monte_carlo_tpu/ops/pallas_sweep.py:327"),
    "resolve_pairs": dict(
        source="argon_monte_carlo_tpu_torch/kernels/csrc/resolve_pairs.cu",
        replaces="argon_monte_carlo_tpu/ops/collide.py:1042"),
    "flush_hist": dict(
        source="argon_monte_carlo_tpu_torch/kernels/csrc/flush_hist.cu",
        replaces="e3a8dc0^:argon_monte_carlo_tpu/ops/pallas_hist.py:71"),
}
PAIRS_KERNELS = {
    "compact": dict(
        source="argon_monte_carlo_tpu_torch/kernels/csrc/compact.cu",
        replaces="argon_monte_carlo_tpu/ops/compact.py:23"),
    "rebuild_sweep": dict(
        source="argon_monte_carlo_tpu_torch/kernels/csrc/rebuild_sweep.cu",
        replaces="argon_monte_carlo_tpu/ops/collide.py:625"),
    "emit_pairs": dict(
        source="argon_monte_carlo_tpu_torch/kernels/csrc/compact.cu",
        replaces="argon_monte_carlo_tpu/ops/pairs.py:208"),
    "test_and_resolve": dict(
        source="argon_monte_carlo_tpu_torch/kernels/csrc/test_resolve.cu",
        replaces="argon_monte_carlo_tpu/ops/pairs.py:282"),
    "research_dirty": dict(
        source="argon_monte_carlo_tpu_torch/kernels/csrc/research.cu",
        replaces="argon_monte_carlo_tpu/ops/pairs.py:433"),
    "flush_hist_compacted": dict(
        source="argon_monte_carlo_tpu_torch/kernels/csrc/flush_hist.cu",
        replaces="argon_monte_carlo_tpu/ops/measure.py:88"),
}


class CheckFailed(RuntimeError):
    pass


def require(cond, what):
    if not cond:
        raise CheckFailed(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def timed_ms(fn, reps: int) -> float:
    """Mean time of ``fn`` on the card over ``reps`` calls (CUDA events,
    after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ulp_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in float32 ulps between two float32 tensors."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    if a.numel() == 0:
        return 0
    return int((ordered(a) - ordered(b)).abs().max())


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def exact(name, got, want):
    require(torch.equal(got, want), f"{name}: kernel != plain")


def config(particles=PARTICLES, **engine):
    return amt.temperature_pore_config(
        engine=amt.EngineConfig(broadphase="cells", **engine)
    ).scaled_to(particles)


def maybe_timed(fn, reps: int):
    """``timed_ms`` when ``reps`` is positive, else None (the card tests
    run the checks untimed)."""
    return timed_ms(fn, reps) if reps > 0 else None


def path_sum_rel(a, b) -> float:
    return float(((a.path_sum.double() - b.path_sum.double()).abs()
                  / b.path_sum.double().abs().clamp(min=1e-30)).max())


def check_kernels(tag: str) -> dict:
    """Phase 2: each kernel vs its plain version on the card."""
    cfg = config()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    state = init_pore(cfg, gen, dev)
    # One drift, so the positions are those a step bins (strays included).
    state = dataclasses.replace(state, pos=state.pos + cfg.dt * state.vel)
    n = state.num_particles
    wl = amt.make_workload(cfg)
    _, grid = amt.engine.build_grids(wl, dev)
    r = cfg.physics.collision_range
    results = {}

    # K2, at the auto capacity and at capacity 8 so that cells overflow.
    k2_ms = k2_plain_ms = None
    for cap in (None, 8):
        g = grid if cap is None else amt.engine.build_grids(
            amt.make_workload(config(cell_capacity=cap)), dev)[1]
        got = collide.bin_and_table(state.pos, g)
        want = collide.bin_and_table_plain(state.pos, g)
        for name, a, b in zip(("cell_id", "table", "pslot", "overflow"),
                              got, want):
            exact(f"K2 {name} (capacity {g.capacity})", a, b)
        print(f"K2 bin_and_table capacity={g.capacity}: exact; "
              f"overflow={int(got[3])} {tag}")
        if cap == 8:
            require(int(got[3]) > 0, "K2: capacity 8 did not overflow")
        else:
            k2_ms = timed_ms(lambda: collide.bin_and_table(state.pos, g), 20)
            k2_plain_ms = timed_ms(
                lambda: collide.bin_and_table_plain(state.pos, g), 5)
    results["bin_and_table"] = (0.0, k2_ms, k2_plain_ms)

    # K9.
    _, table, pslot, _ = collide.bin_and_table(state.pos, grid)
    partner = collide.partner_sweep(state.pos, table, pslot, grid, r)
    exact("K9 partner", partner,
          collide.partner_sweep_plain(state.pos, table, pslot, grid, r))
    print(f"K9 partner_sweep: exact; {int((partner >= 0).sum())} particles "
          f"with a partner {tag}")
    results["partner_sweep"] = (
        0.0,
        timed_ms(lambda: collide.partner_sweep(state.pos, table, pslot,
                                               grid, r), 20),
        timed_ms(lambda: collide.partner_sweep_plain(state.pos, table, pslot,
                                                     grid, r), 3),
    )

    # K10, with paths, has_collided and staging drawn from the Generator.
    u = torch.rand((n, 6), generator=gen, device=dev)
    state = dataclasses.replace(state, paths=u[:, :4] * 2e-7,
                                has_collided=u[:, 4] < 0.6)
    meas = Measurements.zeros(cfg.engine.num_bins, torch.float32, n, dev)
    meas = dataclasses.replace(meas, pending_vals=u[:, :4].flip(1) * 1e-6,
                               pending_mask=u[:, 5] < 0.1)
    got_s, got_m, got_c = collide.resolve_pairs(state, meas, partner, r)
    want_s, want_m, want_c = collide.resolve_pairs_plain(state, meas,
                                                         partner, r)
    exact("K10 count", got_c.int(), want_c.int())
    exact("K10 has_collided", got_s.has_collided, want_s.has_collided)
    exact("K10 pending_mask", got_m.pending_mask, want_m.pending_mask)
    exact("K10 pending_vals", got_m.pending_vals, want_m.pending_vals)
    floats = [(got_s.pos, want_s.pos), (got_s.vel, want_s.vel),
              (got_s.paths, want_s.paths)]
    k10_ulps = max(ulp_diff(a, b) for a, b in floats)
    k10_err = max(max_abs(a, b) for a, b in floats)
    # Stated bound: 2 ulp (both round every operation once, IEEE).
    require(k10_ulps <= 2, f"K10: {k10_ulps} ulp from plain")
    print(f"K10 resolve_pairs: {int(got_c)} pairs, count and staging "
          f"exact, state {k10_ulps} ulp from plain (bound 2), max abs err "
          f"{k10_err!r} {tag}")
    results["resolve_pairs"] = (
        k10_err,
        timed_ms(lambda: collide.resolve_pairs(state, meas, partner, r), 20),
        timed_ms(lambda: collide.resolve_pairs_plain(state, meas, partner, r),
                 5),
    )

    # K7: the staging K10 left (realistic, compacted branch), a dense
    # staging over a small capacity (events dropped), and capacity >= N
    # (the dense branch).
    nb, hi = cfg.engine.num_bins, cfg.engine.hist_range[1]
    dense = dataclasses.replace(
        got_m, pending_mask=u[:, 5] < 0.25,
        hist=torch.randint(0, 50, got_m.hist.shape, generator=gen,
                           device=dev).float(),
        path_sum=u[:4, 0] * 1e-3)
    k7_err = 0.0
    for label, m, cap in (("staging after K10", got_m, measure_ops.FLUSH_CAPACITY),
                          ("dense, capacity 4096", dense, 4096),
                          ("capacity >= N", dense, n)):
        a = measure_ops.flush_hist(m, nb, hi, capacity=cap)
        b = measure_ops.flush_hist_plain(m, nb, hi, capacity=cap)
        exact(f"K7 hist ({label})", a.hist, b.hist)
        for f in ("path_count", "hist_drop_count", "pending_mask",
                  "pending_vals"):
            exact(f"K7 {f} ({label})", getattr(a, f), getattr(b, f))
        rel = float(((a.path_sum.double() - b.path_sum.double()).abs()
                     / b.path_sum.double().abs().clamp(min=1e-30)).max())
        require(rel <= 1e-6, f"K7 path_sum ({label}): rel {rel}")
        k7_err = max(k7_err, max_abs(a.path_sum, b.path_sum))
        if cap == 4096:
            require(int(a.hist_drop_count) > 0, "K7: no events dropped")
        print(f"K7 flush_hist ({label}): hist and counts exact, "
              f"events={int(a.path_count) - int(m.path_count)}, "
              f"dropped={int(a.hist_drop_count) - int(m.hist_drop_count)}, "
              f"path_sum rel err {rel!r} (bound 1e-6) {tag}")
    results["flush_hist"] = (
        k7_err,
        timed_ms(lambda: measure_ops.flush_hist(got_m, nb, hi), 20),
        timed_ms(lambda: measure_ops.flush_hist_plain(got_m, nb, hi), 5),
    )
    for name, (_, ms, plain_ms) in results.items():
        verdict = "slower than" if ms > plain_ms else "faster than"
        print(f"time {name}: kernel {ms!r} ms, plain {plain_ms!r} ms "
              f"(kernel {verdict} plain) at N={n} {tag}")
    return results


# --------------------------------------------------------------------------
# The pairs engine's kernels, each against its plain version.  The card
# tests (tests/test_torch_kernels_cuda.py) call these at a smaller size
# with reps=0 (untimed).
# --------------------------------------------------------------------------


def pairs_case(particles: int = PARTICLES):
    """The pairs configuration at ``particles``: state of seed 17 after one
    drift from init_pore, its grid, PairConfig and Generator."""
    cfg = config(particles, **PAIRS)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    state = init_pore(cfg, gen, dev)
    state = dataclasses.replace(state, pos=state.pos + cfg.dt * state.vel)
    wl = amt.make_workload(cfg)
    _, grid = build_grids(wl, dev)
    return SimpleNamespace(cfg=cfg, dev=dev, gen=gen, state=state, grid=grid,
                           pcfg=pairs_config_for(wl), n=state.num_particles,
                           cr=cfg.physics.collision_range, dt=cfg.dt)


def check_compact(case, tag: str, reps: int):
    """K6 on masks of three densities, truncated and padded; timed at the
    engine's shared per-step compaction."""
    n = case.n
    u = torch.rand(n, generator=case.gen, device=case.dev)
    for density in (1e-3, 0.1, 0.9):
        mask = u < density
        count = int(mask.sum())
        for size in (max(count // 2, 1), count + 1000):
            exact(f"K6 compact (density {density}, size {size})",
                  compact.compact_indices(mask, size, n),
                  compact.compact_indices_plain(mask, size, n))
        print(f"K6 compact density={density}: {count} set, sizes "
              f"{max(count // 2, 1)} and {count + 1000}: exact {tag}")
    shared = max(measure_ops.FLUSH_CAPACITY, n // 64)
    mask = u < 3e-3
    return (0.0,
            maybe_timed(lambda: compact.compact_indices(mask, shared, n),
                        reps),
            maybe_timed(lambda: compact.compact_indices_plain(mask, shared, n),
                        reps))


def check_rebuild_sweep(case, tag: str, reps: int):
    """K1 at the pairs capacity and at capacity 8 (cells spill); exact."""
    pcfg = case.pcfg
    reach, clipped = pairs_ops.reach_radii(
        case.state.vel, case.cr, case.dt, pcfg.rebuild_interval,
        0.5 * case.grid.cell_size)
    pos = case.state.pos
    timing = None
    for capacity in (None, 8):
        grid = case.grid
        if capacity is not None:
            cfg8 = dataclasses.replace(case.cfg, engine=dataclasses.replace(
                case.cfg.engine, cell_capacity=capacity))
            grid = build_grids(amt.make_workload(cfg8), case.dev)[1]
        _, table, pslot, overflow = collide.bin_and_table(pos, grid)
        args = (pos, reach, table, pslot, grid, pcfg.top_k)
        got = collide.rebuild_sweep(*args)
        want = collide.rebuild_sweep_plain(*args)
        for name, a, b in zip(("cands", "unswept", "pos0", "reach0"), got,
                              want):
            exact(f"K1 {name} (capacity {grid.capacity})", a, b)
        cands = got[0]
        print(f"K1 rebuild_sweep capacity={grid.capacity}: exact; "
              f"{int((cands >= 0).sum())} candidates, "
              f"{int((cands[:, -1] >= 0).sum())} full rows, "
              f"{int(got[1].sum())} unswept, {int(overflow)} over capacity "
              f"{tag}")
        if capacity is None:
            timing = (maybe_timed(lambda: collide.rebuild_sweep(*args), reps),
                      maybe_timed(lambda: collide.rebuild_sweep_plain(*args),
                                  min(reps, 3)))
        else:
            require(int(overflow) > 0, "K1: capacity 8 did not spill")
    return (0.0, *timing)


def check_emit_pairs(case, tag: str, reps: int):
    """K5 on the K1 candidates, at the configured pair capacity and at half
    the candidate count (entries dropped)."""
    pcfg, grid, pos = case.pcfg, case.grid, case.state.pos
    reach, clipped = pairs_ops.reach_radii(
        case.state.vel, case.cr, case.dt, pcfg.rebuild_interval,
        0.5 * grid.cell_size)
    _, table, pslot, overflow = collide.bin_and_table(pos, grid)
    cands, unswept, _, _ = collide.rebuild_sweep(pos, reach, table, pslot,
                                                 grid, pcfg.top_k)
    zero = torch.zeros((), dtype=torch.int32, device=case.dev)
    count = int((cands >= 0).sum())
    timing = None
    for m_cap in (pcfg.pair_capacity, count // 2):
        args = (cands, pslot, clipped, unswept, overflow, zero, zero,
                grid.num_cells * grid.capacity, m_cap)
        got = pairs_ops.emit_pairs(*args)
        want = pairs_ops.emit_pairs_plain(*args)
        for name, a, b in zip(("a", "b", "cursor", "hot", "pending1",
                               "overflow", "spill"), got, want):
            exact(f"K5 {name} (pair_capacity {m_cap})", a, b)
        print(f"K5 emit_pairs pair_capacity={m_cap}: exact; "
              f"cursor={int(got[2])} hot={int(got[3].sum())} "
              f"pending1={int(got[4].sum())} overflow={int(got[5])} "
              f"spill={int(got[6])} {tag}")
        if m_cap < count:
            require(int(got[5]) > 0, "K5: small pair_capacity dropped none")
        else:
            timing = (maybe_timed(lambda: pairs_ops.emit_pairs(*args), reps),
                      maybe_timed(lambda: pairs_ops.emit_pairs_plain(*args),
                                  min(reps, 5)))
    return (0.0, *timing)


def check_test_and_resolve(case, plist, tag: str, reps: int):
    """K3 one drift after the rebuild, with paths, has_collided and staging
    drawn from the Generator; also at event_capacity 64 (events dropped).
    Returns (result, state and measurements after the kernel)."""
    n, dev = case.n, case.dev
    state = case.state
    u = torch.rand((n, 6), generator=case.gen, device=dev)
    state = dataclasses.replace(
        state, pos=state.pos + case.dt * state.vel, paths=u[:, :4] * 2e-7,
        has_collided=u[:, 4] < 0.6)
    meas = dataclasses.replace(
        Measurements.zeros(case.cfg.engine.num_bins, torch.float32, n, dev),
        pending_vals=u[:, :4].flip(1) * 1e-6, pending_mask=u[:, 5] < 0.1)
    err, timing, after = 0.0, None, None
    for e_cap in (case.pcfg.event_capacity, 64):
        args = (state, meas, plist.a, plist.b, case.cr, e_cap)
        gs, gm, gc, gmask = pairs_ops.test_and_resolve(*args)
        ws, wm, wc, wmask = pairs_ops.test_and_resolve_plain(*args)
        exact("K3 n_collisions", gc, wc)
        exact("K3 collided", gmask, wmask)
        exact("K3 has_collided", gs.has_collided, ws.has_collided)
        for f in ("pending_mask", "pending_vals", "collision_count",
                  "overflow_count"):
            exact(f"K3 {f} (event_capacity {e_cap})", getattr(gm, f),
                  getattr(wm, f))
        floats = [(gs.pos, ws.pos), (gs.vel, ws.vel), (gs.paths, ws.paths)]
        ulps = max(ulp_diff(a, b) for a, b in floats)
        # Stated bound: 2 ulp (both round every operation once, IEEE).
        require(ulps <= 2, f"K3: {ulps} ulp from plain")
        err = max(err, max(max_abs(a, b) for a, b in floats))
        print(f"K3 test_and_resolve event_capacity={e_cap}: {int(gc)} pairs, "
              f"events dropped={int(gm.overflow_count)}; mask, count, "
              f"staging and counters exact, state {ulps} ulp from plain "
              f"(bound 2) {tag}")
        if e_cap == 64:
            require(int(gm.overflow_count) > 0, "K3: no events dropped")
        else:
            require(int(gc) > 0, "K3: no pair resolved")
            after = (gs, gm, gmask)
            timing = (maybe_timed(lambda: pairs_ops.test_and_resolve(*args),
                                  reps),
                      maybe_timed(
                          lambda: pairs_ops.test_and_resolve_plain(*args),
                          min(reps, 5)))
    return (err, *timing), after


def check_research_dirty(case, plist, state, tag: str, reps: int):
    """K4 on a dirty set of research_capacity particles drawn from the
    Generator, with the table-dropped particles and 8 particles sped up to
    40 km/s (their reach clips), half of all particles bumped; also at
    append_capacity 64 (coverage lost)."""
    n, dev, pcfg, grid = case.n, case.dev, case.pcfg, case.grid
    dropped = torch.nonzero(
        plist.pslot0 >= grid.num_cells * grid.capacity).flatten()[:64]
    perm = torch.randperm(n, generator=case.gen, device=dev)
    vel = state.vel.clone()
    vel[perm[:8], 0] = 4e4
    moved = dataclasses.replace(state, vel=vel)
    pick = torch.unique(torch.cat([
        perm[:pcfg.research_capacity - dropped.numel()], dropped]))
    dirty_idx = torch.full((pcfg.research_capacity,), n, dtype=torch.int32,
                           device=dev)
    dirty_idx[:pick.numel()] = pick.to(torch.int32)
    bump = torch.rand(n, generator=case.gen, device=dev) < 0.5
    timing = None
    for append in (pcfg.append_capacity, 64):
        p = dataclasses.replace(pcfg, append_capacity=append)
        args = (moved, plist, dirty_idx, bump, grid, p, case.cr, case.dt)
        got, glost, glat = pairs_ops.research_dirty(*args)
        want, wlost, wlat = pairs_ops.research_dirty_plain(*args)
        for f in ("a", "b", "cursor", "hot", "reach0", "overflow"):
            exact(f"K4 {f} (append_capacity {append})", getattr(got, f),
                  getattr(want, f))
        exact("K4 lost", glost, wlost)
        exact("K4 latent_per", glat, wlat)
        print(f"K4 research_dirty append_capacity={append}: exact; "
              f"{pick.numel()} dirty ({dropped.numel()} table-dropped), "
              f"appended={int(got.cursor) - int(plist.cursor)} "
              f"hot={int(got.hot.sum())} latent={int(glat.sum())} "
              f"overflow={int(got.overflow)} lost={bool(glost)} {tag}")
        if append == 64:
            require(bool(glost), "K4: append_capacity 64 lost nothing")
        else:
            timing = (maybe_timed(lambda: pairs_ops.research_dirty(*args),
                                  reps),
                      maybe_timed(lambda: pairs_ops.research_dirty_plain(
                          *args), min(reps, 5)))
    return (0.0, *timing)


def check_flush_compacted(case, meas, tag: str, reps: int):
    """K7's compacted entry on K3's staging: with the engine's shared
    compaction width (some staged events left out of event_idx, so they
    count as drops) and with every event listed."""
    n = case.n
    nb, hi = case.cfg.engine.num_bins, case.cfg.engine.hist_range[1]
    shared = max(measure_ops.FLUSH_CAPACITY, n // 64)
    count = int(meas.pending_mask.sum())
    err, timing = 0.0, None
    for size in (shared, count + 100):
        idx = compact.compact_indices(meas.pending_mask, size, n)
        a = measure_ops.flush_hist_compacted(meas, idx, nb, hi)
        b = measure_ops.flush_hist_compacted_plain(meas, idx, nb, hi)
        for f in ("hist", "path_count", "hist_drop_count", "pending_mask",
                  "pending_vals"):
            exact(f"K7c {f} (event_idx size {size})", getattr(a, f),
                  getattr(b, f))
        rel = path_sum_rel(a, b)
        require(rel <= 1e-6, f"K7c path_sum: rel {rel}")
        err = max(err, max_abs(a.path_sum, b.path_sum))
        print(f"K7c flush_hist_compacted event_idx size={size}: hist and "
              f"counts exact, events={count}, "
              f"dropped={int(a.hist_drop_count)}, path_sum rel err {rel!r} "
              f"(bound 1e-6) {tag}")
        if size < count:
            require(int(a.hist_drop_count) > 0, "K7c: no event left out")
        else:
            timing = (maybe_timed(lambda: measure_ops.flush_hist_compacted(
                          meas, idx, nb, hi), reps),
                      maybe_timed(
                          lambda: measure_ops.flush_hist_compacted_plain(
                              meas, idx, nb, hi), min(reps, 5)))
    return (err, *timing)


def check_pairs_kernels(tag: str, particles: int = PARTICLES,
                        reps: int = 20) -> dict:
    """Phase 2, pairs side: K6, K1, K5, K3, K4 and K7c against their plain
    versions on the card."""
    case = pairs_case(particles)
    results = {"compact": check_compact(case, tag, reps),
               "rebuild_sweep": check_rebuild_sweep(case, tag, reps),
               "emit_pairs": check_emit_pairs(case, tag, reps)}
    plist = pairs_ops.rebuild(
        case.state, case.grid, case.pcfg, case.cr, case.dt,
        pairs_ops.PairList.init(case.n, case.grid, case.pcfg, torch.float32,
                                case.dev))
    results["test_and_resolve"], (state, meas, _) = check_test_and_resolve(
        case, plist, tag, reps)
    results["research_dirty"] = check_research_dirty(case, plist, state, tag,
                                                     reps)
    results["flush_hist_compacted"] = check_flush_compacted(case, meas, tag,
                                                            reps)
    for name, (_, ms, plain_ms) in results.items():
        verdict = "slower than" if ms > plain_ms else "faster than"
        print(f"time {name}: kernel {ms!r} ms, plain {plain_ms!r} ms "
              f"(kernel {verdict} plain) at N={case.n} {tag}")
    return results


# --------------------------------------------------------------------------
# Whole engines
# --------------------------------------------------------------------------


def check_against_cpu(tag: str, **engine) -> None:
    """A slice on the card against the same slice on the CPU -- the plain
    versions, which tests/test_torch_engine.py holds to the JAX reference
    -- from one initial state with one set of per-step uniforms, at a small
    size.  Counts and the histogram must be equal; the state may differ by
    the cos/sin rounding of the two devices (a few ulp a step)."""
    steps = 10
    label = engine.get("narrowphase", "sweep")
    cfg = amt.temperature_pore_config(
        engine=amt.EngineConfig(steps_per_epoch=5, **engine)).scaled_to(
            20_000)
    cpu = amt.Simulation(amt.make_workload(cfg), device="cpu")
    gpu = amt.Simulation(amt.make_workload(cfg), device="cuda")
    state, meas, gen = cpu.init(SEED)
    uniforms = torch.rand((steps, state.num_particles, 2), generator=gen)

    def to_card(obj):
        return dataclasses.replace(obj, **{
            f.name: getattr(obj, f.name).cuda()
            for f in dataclasses.fields(obj)})

    s_c, m_c, met_c = cpu.run(steps, state=state, measure=meas,
                              draw=lambda i: uniforms[i])
    s_g, m_g, met_g = gpu.run(steps, state=to_card(state),
                              measure=to_card(meas),
                              draw=lambda i: uniforms[i].cuda())
    for f in ("collisions", "wall_hits", "oob_after_walls",
              "oob_after_pairs", "rebuilt"):
        exact(f"{label} small run {f}", getattr(met_g, f).cpu(),
              getattr(met_c, f))
    for f in ("hist", "path_count", "collision_count", "err_count",
              "overflow_count", "hist_drop_count", "hot_spill_count"):
        exact(f"{label} small run {f}", getattr(m_g, f).cpu(),
              getattr(m_c, f))
    exact(f"{label} small run has_collided", s_g.has_collided.cpu(),
          s_c.has_collided)
    rel = max(
        float((getattr(s_g, f).cpu() - getattr(s_c, f)).abs().max()
              / getattr(s_c, f).abs().max())
        for f in ("pos", "vel", "paths"))
    require(rel <= 1e-5, f"{label} small run: state differs by {rel} "
            f"relative")
    pairs = int((met_c.collisions - met_c.wall_hits).sum())
    require(pairs > 0, f"{label} small run: no pair collisions")
    print(f"{label} small run vs CPU: N={state.num_particles} steps={steps} "
          f"pairs={pairs} wall_hits={int(met_c.wall_hits.sum())} "
          f"dirty={met_g.dirty_count.tolist()} (CPU "
          f"{met_c.dirty_count.tolist()}): counts and histogram equal, state "
          f"max rel err {rel!r} (bound 1e-5) {tag}")


def compare_pairs_with_sweep(tag: str) -> None:
    """Phase 4: the pairs engine against the sweep engine on the card, at
    1M particles for 100 steps, from one state; step i's uniforms come
    from a Generator seeded with (SEED, i), so nothing is drawn ahead."""
    steps = 100
    dev = torch.device("cuda")
    sweep = amt.Simulation(amt.make_workload(config()), device="cuda")
    pairs = amt.Simulation(amt.make_workload(config(**PAIRS)), device="cuda")
    state, meas, _ = sweep.init(SEED)
    n = state.num_particles

    def draw(i):
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED * 1_000_000 + i)
        return torch.rand((n, 2), generator=gen, device=dev)

    s_s, m_s, s_p, m_p = state, meas, state, meas
    first_diff = None
    per_s, per_p, pmet = [], [], []
    for i in range(steps):
        s_s, m_s, met_s = sweep.run(1, state=s_s, measure=m_s, start_step=i,
                                    draw=draw)
        s_p, m_p, met_p = pairs.run(1, state=s_p, measure=m_p, start_step=i,
                                    draw=draw)
        per_s.append(met_s.collisions - met_s.wall_hits)
        per_p.append(met_p.collisions - met_p.wall_hits)
        pmet.append(met_p)
        same = torch.equal(s_s.pos, s_p.pos) and torch.equal(s_s.vel, s_p.vel)
        if first_diff is None and not same:
            first_diff = i
        if i == 0:
            step0 = (int(m_p.overflow_count), int(met_p.dirty_count[0]))
    per_s = torch.cat(per_s).tolist()
    per_p = torch.cat(per_p).tolist()
    differ = int(((s_s.pos != s_p.pos).any(-1)
                  | (s_s.vel != s_p.vel).any(-1)).sum())
    tot_s, tot_p = sum(per_s), sum(per_p)
    print(f"pairs vs sweep N={n} steps={steps}: pair collisions sweep "
          f"{tot_s} pairs {tot_p}; first step with different state "
          f"{first_diff}; {differ} particles differ at the end {tag}")
    print(f"pairs vs sweep per-step pair collisions: sweep {per_s} {tag}")
    print(f"pairs vs sweep per-step pair collisions: pairs {per_p} {tag}")
    for f in ("latent_full", "teleports", "latent_research"):
        print(f"pairs vs sweep: pairs {f} "
              f"{torch.stack([getattr(m, f)[0] for m in pmet]).tolist()} "
              f"{tag}")
    require(abs(tot_p - tot_s) <= 0.01 * tot_s,
            f"pairs vs sweep: {tot_p} pair collisions against {tot_s}")
    check_pairs_overflow("pairs vs sweep", pairs, step0,
                         int(m_p.overflow_count), tag)


def check_pairs_overflow(label, sim, step0, total, tag):
    """The pairs engine loses no coverage after step 0.  Step 0 of a fresh
    init_pore state resolves the init's overlapping pairs (~2,000 at 1M),
    so more particles are dirty than the re-search capacity the reference
    sizes for steady state (research_capacity; its own 10M probe logged
    overflow in its first window too); those count in overflow_count, and
    only those may."""
    (ov0, dirty0), cap = step0, sim.pcfg.research_capacity
    require(total == ov0, f"{label}: overflow_count {total - ov0} after "
            f"step 0")
    require(ov0 == 0 or dirty0 > cap,
            f"{label}: overflow {ov0} at step 0 with {dirty0} dirty")
    print(f"{label}: overflow_count={total}, all at step 0 ({dirty0} dirty "
          f"particles against research_capacity {cap}); 0 after it {tag}")


def run_slice(tag: str, names, **engine) -> dict:
    """Phases 5 and 6: one main path, counted."""
    label = engine.get("narrowphase", "sweep")
    cfg = config(steps_per_epoch=STEPS_PER_EPOCH, **engine)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = amt.Simulation(amt.make_workload(cfg), device="cuda")
    state, meas, gen = sim.init(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = state.num_particles

    marks = []

    def on_epoch(_metrics):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    kernels.launch_counts.clear()
    t_run = time.perf_counter()
    # Step 0 alone first, so its counters can be read (check_pairs_overflow).
    state, meas, first = sim.run(num_steps=1, state=state, measure=meas,
                                 generator=gen)
    step0 = (int(meas.overflow_count), int(first.dirty_count[0]))
    state, meas, metrics = sim.run(num_steps=STEPS - 1, state=state,
                                   measure=meas, generator=gen,
                                   start_step=1, epoch_callback=on_epoch)
    torch.cuda.synchronize()
    counts = dict(kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    metrics = StepMetrics.concat([first, metrics])

    # Invariants of the reference engine's temperature-pore test.
    finite = all(bool(torch.isfinite(t).all())
                 for t in (state.pos, state.vel, state.paths))
    require(finite, f"{label} slice: non-finite state")
    require(int(oob.pore_oob_count(state, cfg.geometry)) == 0,
            f"{label} slice: particles out of bounds")
    require(int(meas.err_count) == 0, f"{label} slice: wall-solver errors")
    pairs = int((metrics.collisions - metrics.wall_hits).sum())
    hits = int(metrics.wall_hits.sum())
    require(pairs > 0 and hits > 0,
            f"{label} slice: no collisions or wall hits")
    for f in ("momentum_z", "energy_hot", "energy_cold"):
        require(bool(torch.isfinite(getattr(metrics, f)).all()),
                f"{label} slice: non-finite {f}")
    drop = int(meas.hist_drop_count)
    row_sums = meas.hist.sum(dim=1)
    require(bool((row_sums == int(meas.path_count) - drop).all()),
            f"{label} slice: histogram rows do not sum to path_count - drops")
    for name in names:
        require(counts.get(name, 0) > 0,
                f"{label} slice: kernel {name} not launched")
    if label == "pairs":
        check_pairs_overflow("pairs slice", sim, step0,
                             int(meas.overflow_count), tag)

    # Throughput over the synced epochs after the first.
    steady = (STEPS - 1 - STEPS_PER_EPOCH) / (marks[-1] - marks[0])
    first_epoch_s = marks[0] - t_run
    print(f"{label} slice: N={n} steps={STEPS} pairs={pairs} wall_hits={hits} "
          f"path_count={int(meas.path_count)} hist_drop={drop} "
          f"overflow={int(meas.overflow_count)} err={int(meas.err_count)} "
          f"oob=0 finite=True {tag}")
    print(f"{label} slice: particle-steps/s={steady * n!r} (epochs "
          f"2-{len(marks)} after step 0), first epoch {first_epoch_s!r} s, "
          f"init {init_s!r} s, peak memory {peak / 2**30!r} GiB {tag}")
    if label == "pairs":
        k = sim.pcfg.rebuild_interval
        m_cap = sim.pcfg.pair_capacity
        print(f"pairs slice: pair checks/s={steady * m_cap!r} ({m_cap} "
              f"listed entries tested a step), "
              f"hot_spill={int(meas.hot_spill_count)}, dirty_count "
              f"{int(metrics.dirty_count.min())}-"
              f"{int(metrics.dirty_count.max())}, latent_full "
              f"{int(metrics.latent_full.sum())}, teleports "
              f"{int(metrics.teleports.sum())}, latent_research "
              f"{int(metrics.latent_research.sum())} {tag}")
        # One window timed with CUDA events: the rebuild, then K steps.
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        sim.rebuild(state)
        ev[1].record()
        sim.run(num_steps=k, state=state, measure=meas, generator=gen)
        ev[2].record()
        torch.cuda.synchronize()
        print(f"pairs slice: rebuild {ev[0].elapsed_time(ev[1])!r} ms, step "
              f"{ev[1].elapsed_time(ev[2]) / k!r} ms (mean of one window of "
              f"{k}) {tag}")
    print(f"{label} slice: launches {counts} {tag}")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    tag = f"[{card}]"
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)} {tag}")

    t0 = time.perf_counter()
    kernels.library()
    build_s, log = kernels.build_info()
    print(f"build: {time.perf_counter() - t0!r} s "
          f"(nvcc {build_s!r} s; None = already built) {tag}")
    for line in log.splitlines():
        if "registers" in line or "error" in line.lower():
            print(f"  ptxas: {line.strip()} {tag}")

    results = check_kernels(tag)
    results.update(check_pairs_kernels(tag))
    check_against_cpu(tag)
    check_against_cpu(tag, narrowphase="pairs", rebuild_interval=5)
    compare_pairs_with_sweep(tag)
    counts = run_slice(tag, KERNELS)
    pairs_counts = run_slice(tag, ["bin_and_table", *PAIRS_KERNELS], **PAIRS)
    counts.update({name: pairs_counts[name] for name in PAIRS_KERNELS})

    sources = {**KERNELS, **PAIRS_KERNELS}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", **sources[name],
         "launches": counts[name], "max_abs_err": err, "ms": ms,
         "plain_ms": plain_ms}
        for name, (err, ms, plain_ms) in results.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
