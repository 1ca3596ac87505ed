#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each prints its lines; any failed check raises and the script
exits non-zero without a result line):

0. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
1. build the CUDA kernels from ``argon_monte_carlo_tpu_torch/kernels``
   (one ``nvcc`` process a source, all started together); then the ledger
   gate: the main path (pairs, K=8) at the reference scale, 557,649
   molecules for 250 steps, its per-step ledger against the JAX package's
   in ``parity_momentum_energy.csv`` by the reference's z-test; and the
   same gate on the sharded pairs mode, 4 slabs of the one card;
2. each kernel against its plain PyTorch version on the same tensors on the
   card, at the shapes of the 1M-particle temperature pore (the sweep's
   K2, K9, K10, K7, K2 and K9 also at cell capacity 8 so that cells
   overflow; K10 in place, each side on its own copy, also with a chain
   k -> i <-> j, with self-partners, with matched pairs split between a
   local and a ghost lane, and as one launch recorded in a CUDA graph and
   replayed three times; K7 in place, each side on its own copy, over its
   capacity (the look-back's cut), under it, on one slab's lanes, over two
   calls in a row and as one launch recorded in a CUDA graph and replayed
   three times on changed staging; the pairs engine's K6, K1, K5, K3, K4
   and K7's compacted entry, K6 also at lengths around its tile, on an
   unaligned view, over 100 calls in a row and as one launch recorded in
   a CUDA graph and replayed; K5 at two capacities and as one launch
   replayed three times on shrinking lists, each shorter than the tail
   the one before left; K1 also with overflowing cells, a cut active list
   and rows that saturate top_k; K3, K4 and K7's compacted entry in place, each on
   its own copy of the inputs and returning the tensors it was given: K4
   also with a small append budget, a cursor near the list's end and
   lists that fill, K3 also at event capacity 64 and with reversed and
   repeated duplicate entries, K7c with some events unlisted and with all
   listed, K3 and K7c also recorded in a CUDA graph and replayed three
   times on changed inputs; K8, the fused drift/walls/recapture pass,
   over 16 steps of the pairs slice, as one launch recorded in a CUDA
   graph and replayed three times (K1 and K4 too, on moved positions), and
   with the missed-case audit over 8 more: its ten counts against the
   plain audit, its state and ledger
   bitwise those of K8 without it, its device time with and without); K14,
   the specular pore's drift/walls/nudge pass, over 16 steps of its pairs
   slice at 1M, in place with a slab's ghost staging rows and the audit:
   every output bitwise the plain version's, the audit's counts equal;
   K13,
   the pairs step's post-pairs recapture and dirty masks, on the 1M pore
   with rows planted in every branch of the recapture and on its edges:
   every output and count bitwise the plain version's, in place, and as
   one launch recorded in a CUDA graph and replayed three times; and
   of the 24,627-particle cube (K2 on the cube's grid, centred on the box;
   K11,
   also at ~200k, with every particle in one z-slab, with probe pairs at
   the window's edges, and as one call replayed in a CUDA graph), with the kernel's, the plain version's and, where one exists,
   the library call's time beside the kernel's bound; K2 also with a cell
   of more than 100 particles, with all in one cell, over calls in a row
   and as one call recorded in a CUDA graph and replayed on moved
   positions; K12 (band and index packing, and both directions of an
   exchange in one launch) at the band sizes of the 1M pore cut in 4
   z-slabs, with room, truncated, empty and graph-replayed, and K2, K9 and
   K10 with their z-slab arguments on one slab's local and ghost lanes (K9
   also ordering its candidates by global id, the sharded sweep's form);
   K1, K5, K3 and K4 with theirs (global ids, valid lanes, the slab's
   windows, the local mask) on the arguments the sharded pairs mode hands
   them for one of 4 slabs of the 1M pore, captured from its run;
3. the sweep slice, the pairs slice, the cube, the 4-slab sharded sweep
   and the 4-slab sharded pairs mode on the card against the same slices
   on the CPU (the plain versions,
   which the CPU tests hold to the JAX package) at a small size, from one
   state with one set of uniforms;
4. the pairs engine against the sweep engine on the card at 1M particles,
   100 steps, from one state with one set of uniforms;
5. the sweep slice: ``Simulation(make_workload(cfg), device="cuda")`` for
   300 steps at 1M particles, float32, its invariants, throughput, init
   time and peak memory, with the launch count of every kernel in that run;
6. the pairs slice (``narrowphase="pairs"``, ``rebuild_interval=8``) the
   same way, with the rebuild and step times of one window;
7. the cube slice: ``Simulation(make_workload(CubeConfig()))``, 24,627
   particles for 500 steps, and the reference's mean-free-path check on
   its own validation configuration;
8. the sharded slice: ``ShardedSimulation(make_workload(cfg), n_shards=4)``
   at 1M particles with all four slabs on the one card, 300 steps:
   particles and global ids conserved after every epoch, no overflow, halo
   and migrant traffic across every interior face, pair collisions within
   1% of the single-slab sweep's; the sharded pairs mode the same way
   (K=8; no overflow after the first window, pair collisions within 1% of
   the sharded sweep's, every kernel launched as its steps and rebuilds
   ask); the sharded cube (24,627 particles on cells, 4 slabs, 500
   steps: kinetic energy within 1e-5, the mean free path within 5% of
   the one-card cube's) and the reference's mean-free-path check on 4
   slabs; the specular pore, one slab, 1M
   particles for 100 steps, its kinetic energy constant, on the sweep and
   on the replayed pairs path (the replay bitwise the loop, K14 once a
   step); the cube on the
   cell grid (K2, K9) against the cube on all pairs (K11), 100 steps,
   bitwise; the command line in this process (``cli.main``): the main
   path at 557,649 molecules for 200 steps with checkpoints, a resume from
   step 100 whose step-200 checkpoint is bitwise the first run's, the
   files it writes; short runs with the audit, on 4 slabs, of the cube on
   cells and on 4 slabs, each with its wall time; the sharded pairs mode
   at 200k on 4 slabs resumed mid-window, its step-40 checkpoint bitwise
   the whole run's;
9. where the time goes in each slice: untraced step time (CUDA events),
   device time and device operations a step (``torch.profiler``), host
   time of the step and of its per-particle stage (``cProfile``); the
   sharded sweep and the sharded pairs mode at 1, 2 and 4 slabs and the
   sharded cube on 4; K6's wrapper beside
   ``torch.nonzero``; K2 and K12 timed alone; K7, K11, K10 and K5 alone,
   device time and launches a call (K8's with and without the audit, in
   phase 2).

The line before the last is the kernels line: each kernel's launches on
its main path, and on every path in ``path_launches``, beside its times
and bound (K1, K5, K3 and K4 also in their slab forms).  The last line is
``{"ok": true, "device": {...}}``.  There is no CPU path:
without CUDA the script stops before printing any result.
``python3 chip_smoke.py --breakdown`` runs phases 0, 1 and 9 only; a copy
of the script placed beside another checkout's package reads that
checkout's step the same way, so two commits compare in one call.
"""

from __future__ import annotations

import argparse
import cProfile
import csv
import dataclasses
import inspect
import json
import math
import pstats
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

import argon_monte_carlo_tpu_torch as amt
from argon_monte_carlo_tpu_torch import kernels
from argon_monte_carlo_tpu_torch.engine import (WallLedger, build_grids,
                                                pairs_config_for)
from argon_monte_carlo_tpu_torch import init as init_ops
from argon_monte_carlo_tpu_torch.ops import collide, measure as measure_ops
from argon_monte_carlo_tpu_torch.ops import compact, oob, pack
from argon_monte_carlo_tpu_torch.ops import pairs as pairs_ops
from bench_torch.counts import cells, k8
from bench_torch.counts.roofline import (  # noqa: F401 (chip_smoke's too)
    FP32_OPS_PER_S, HBM_BYTES_PER_S, PAIR_TEST_OPS, bound, tensor_bytes)
from argon_monte_carlo_tpu_torch.state import (Measurements, ParticleState,
                                               StepMetrics)

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
    # The temperature pore's post-pairs recapture and dirty masks.
    "post_pairs": dict(
        source="argon_monte_carlo_tpu_torch/kernels/csrc/post_pairs.cu",
        replaces="argon_monte_carlo_tpu/engine.py:377"),
}
# Both engines of the temperature pore run K8 once a step; the cube's
# broad phase is K11.
WALL_KERNELS = {
    "pore_advance": dict(
        source="argon_monte_carlo_tpu_torch/kernels/csrc/pore_walls.cu",
        replaces="argon_monte_carlo_tpu/models/temperature_pore.py:65"),
}
# Both engines of the specular pore run K14 once a step.
SPECULAR_KERNELS = {
    "specular_advance": dict(
        source="argon_monte_carlo_tpu_torch/kernels/csrc/specular_walls.cu",
        replaces="argon_monte_carlo_tpu/models/pore.py:55"),
}
CUBE_KERNELS = {
    "allpairs_partner": dict(
        source="argon_monte_carlo_tpu_torch/kernels/csrc/allpairs.cu",
        replaces="argon_monte_carlo_tpu/ops/collide.py:1001"),
}
# The z-slab engine packs its halo bands and its migrants with K12's
# two-direction entry, two launches a slab a step.
SHARD_KERNELS = {
    "pack_band_pair": dict(
        source="argon_monte_carlo_tpu_torch/kernels/csrc/pack.cu",
        replaces="argon_monte_carlo_tpu/parallel/shard.py:210"),
    # The sharded pairs mode freezes its export lists with K12's index
    # form, at every window boundary.
    "pack_indices": dict(
        source="argon_monte_carlo_tpu_torch/kernels/csrc/pack.cu",
        replaces="argon_monte_carlo_tpu/parallel/shard.py:232"),
}
SLABS = 4
CUBE_STEPS = 500
CUBE_PARTICLES = 24_627

# The least time the card could take (HBM_BYTES_PER_S, FP32_OPS_PER_S,
# PAIR_TEST_OPS, ``tensor_bytes``, ``bound``) and the pair tests of a cell
# grid (``neighbor_slots``, ``allpairs_cell_tests``) are the benchmark's
# yardstick, ``bench_torch/counts``.
neighbor_slots = cells.neighbor_slots


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


def result(err, ms, plain_ms, nbytes, ops=0.0, library_ms=None) -> dict:
    """One kernel's entry of the kernels line; the bound is the larger of
    its bytes over the memory rate and its float32 operations over the
    float32 rate."""
    bound_ms, bound_by = bound(nbytes, ops)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def print_times(results: dict, n: int, tag: str) -> None:
    for name, r in results.items():
        lib = (f", library {r['library_ms']!r} ms"
               if r["library_ms"] is not None else "")
        print(f"time {name}: kernel {r['ms']!r} ms, plain {r['plain_ms']!r} "
              f"ms{lib}, bound {r['bound_ms']!r} ms ({r['bound_by']}) at "
              f"N={n} {tag}")


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
    state = init_ops.init_pore(cfg, gen, dev)
    # One drift, so the positions are those a step bins (strays included).
    state = dataclasses.replace(state, pos=state.pos + cfg.dt * state.vel)
    n = state.num_particles
    wl = amt.make_workload(cfg)
    host_grid, grid = amt.engine.build_grids(wl, dev)
    r = cfg.physics.collision_range
    results = {}

    # K2, at the auto capacity and at capacity 8 so that cells overflow.
    k2_ms = k2_plain_ms = k2_out = None
    binned = []
    for cap in (None, 8):
        g = grid if cap is None else amt.engine.build_grids(
            amt.make_workload(config(cell_capacity=cap)), dev)[1]
        got = collide.bin_and_table(state.pos, g)
        binned.append((g, got))
        want = collide.bin_and_table_plain(state.pos, g)
        for name, a, b in zip(("cell_id", "table", "pslot", "overflow"),
                              got, want):
            exact(f"K2 {name} (capacity {g.capacity})", a, b)
        print(f"K2 bin_and_table capacity={g.capacity}: exact; "
              f"overflow={int(got[3])} {tag}")
        if cap == 8:
            require(int(got[3]) > 0, "K2: capacity 8 did not overflow")
        else:
            k2_out = got
            k2_ms = timed_ms(lambda: collide.bin_and_table(state.pos, g), 20)
            k2_plain_ms = timed_ms(
                lambda: collide.bin_and_table_plain(state.pos, g), 5)
    check_bin_and_table_hard(state, [g for g, _ in binned], cfg.dt, tag)
    # ~9 float32 operations a particle: 3 subtractions, 3 divisions, 3
    # floors.
    results["bin_and_table"] = result(
        0.0, k2_ms, k2_plain_ms, tensor_bytes(state.pos, k2_out), 9 * n)

    # K9, at the auto capacity and at capacity 8, where particles beyond
    # a full cell's row have no slot: no partner, nobody's candidate.
    for g, (_, table, pslot, overflow) in reversed(binned):
        partner = collide.partner_sweep(state.pos, table, pslot, g, r)
        exact(f"K9 partner (capacity {g.capacity})", partner,
              collide.partner_sweep_plain(state.pos, table, pslot, g, r))
        unlisted = pslot >= g.num_cells * g.capacity
        require(bool((partner[unlisted] == -1).all()),
                "K9: a particle without a slot has a partner")
        print(f"K9 partner_sweep capacity={g.capacity}: exact; "
              f"{int((partner >= 0).sum())} particles with a partner, "
              f"{int(unlisted.sum())} without a slot ({int(overflow)} over "
              f"capacity) {tag}")
    results["partner_sweep"] = result(
        0.0,
        timed_ms(lambda: collide.partner_sweep(state.pos, table, pslot,
                                               grid, r), 20),
        timed_ms(lambda: collide.partner_sweep_plain(state.pos, table, pslot,
                                                     grid, r), 3),
        tensor_bytes(state.pos, table, pslot, grid.neighbors, partner),
        PAIR_TEST_OPS * neighbor_slots(table, pslot, grid, n),
    )

    # K10 in place, with paths, has_collided and staging drawn from the
    # Generator; the chain, self-partner and ghost cases; three replays of
    # one captured launch.
    state, meas = k10_inputs(state, gen, cfg.engine.num_bins)
    _, got_m, got_c, k10_ulps, k10_err, _ = check_k10_case(
        "at 1M", state, meas, partner, r)
    print(f"K10 resolve_pairs: {int(got_c)} pairs, count and staging "
          f"exact, state {k10_ulps} ulp from plain (bound 2), max abs err "
          f"{k10_err!r}, in place, the lanes of no matched pair untouched "
          f"{tag}")
    check_k10_hard_cases(state, meas, partner, r, tag)

    def search(pos):
        _, tbl, ps, _ = collide.bin_and_table(pos, grid)
        return collide.partner_sweep(pos, tbl, ps, grid, r)

    check_resolve_pairs_graph(state, meas, search, r, cfg.dt, gen, tag)
    results["resolve_pairs"] = time_resolve_pairs(state, meas, partner, r,
                                                  k10_err, 20, tag)

    # K7 reads K10's staging within its contract: a row whose mask is clear
    # is zero (K10's own check above keeps arbitrary unstaged rows).
    staged = dataclasses.replace(
        got_m, pending_vals=torch.where(got_m.pending_mask[:, None],
                                        got_m.pending_vals, 0.0))
    results["flush_hist"] = check_flush_dense(staged, gen, cfg, host_grid,
                                              tag)
    print_times(results, n, tag)
    return results


def k10_inputs(state, gen, num_bins: int):
    """``state`` with paths and has_collided, and measurements with
    staging (arbitrary unstaged rows: K10 writes a row only where it
    stages one), drawn from the Generator."""
    n = state.num_particles
    u = torch.rand((n, 6), generator=gen, device=state.pos.device)
    state = dataclasses.replace(state, paths=u[:, :4] * 2e-7,
                                has_collided=u[:, 4] < 0.6)
    meas = Measurements.zeros(num_bins, torch.float32, n, state.pos.device)
    meas = dataclasses.replace(meas, pending_vals=u[:, :4].flip(1) * 1e-6,
                               pending_mask=u[:, 5] < 0.1)
    return state, meas


def k10_matched(state, meas, partner, r: float):
    """The twin's matched mask: the lanes of the pairs K10 resolves."""
    everyone = torch.ones_like(state.has_collided)
    return collide.resolve_pairs_plain(own(state), own(meas), partner, r,
                                       local_mask=everyone)[3]


def check_k10_case(label, state, meas, partner, r: float, local=None):
    """K10 and its twin, each on its own copy of the inputs and its own
    count (both from 7): count, ok mask and staging exact, state within 2
    ulp, the kernel's tensors those it was given, and every lane it
    applies to no pair (outside ``ok & local``) bitwise as given.
    Returns (state, measurements, count, ulps, max abs error) of the
    kernel."""
    gs, gm = own(state), own(meas)
    gc = torch.full((), 7, dtype=torch.int32, device=partner.device)
    wc = gc.clone()
    got = collide.resolve_pairs(gs, gm, partner, r, count=gc,
                                local_mask=local)
    want = collide.resolve_pairs_plain(own(state), own(meas), partner, r,
                                       count=wc, local_mask=local)
    same_tensors(got[0], gs, f"K10 ({label})")
    same_tensors(got[1], gm, f"K10 ({label})")
    require(got[2] is gc, f"K10 ({label}): not the count given")
    exact(f"K10 count ({label})", gc, wc)
    if local is None:
        matched = k10_matched(state, meas, partner, r)
        applied = matched
    else:
        matched = got[3]
        exact(f"K10 ok ({label})", matched, want[3])
        applied = matched & local
    ks, km, ws, wm = got[0], got[1], want[0], want[1]
    exact(f"K10 has_collided ({label})", ks.has_collided, ws.has_collided)
    exact(f"K10 pending_mask ({label})", km.pending_mask, wm.pending_mask)
    exact(f"K10 pending_vals ({label})", km.pending_vals, wm.pending_vals)
    floats = [(ks.pos, ws.pos), (ks.vel, ws.vel), (ks.paths, ws.paths)]
    ulps = max(ulp_diff(a, b) for a, b in floats)
    # Stated bound: 2 ulp (both round every operation once, IEEE).
    require(ulps <= 2, f"K10 ({label}): {ulps} ulp from plain")
    rest = ~applied
    for f, mine, given in (
            ("pos", ks.pos, state.pos), ("vel", ks.vel, state.vel),
            ("paths", ks.paths, state.paths),
            ("has_collided", ks.has_collided, state.has_collided),
            ("pending_vals", km.pending_vals, meas.pending_vals),
            ("pending_mask", km.pending_mask, meas.pending_mask)):
        exact(f"K10 {f} of the lanes not applied to ({label})", mine[rest],
              given[rest])
    return (ks, km, gc, ulps, max(max_abs(a, b) for a, b in floats),
            matched)


def check_k10_hard_cases(state, meas, partner, r: float, tag: str) -> None:
    """K10 where the partner array is hard: up to 200 lanes without a
    partner pointed at a lane of a matched pair (a chain k -> i while i <->
    j), up to 200 lanes partnered with themselves (not a pair: nothing
    written), and a local mask that splits every matched pair between a
    local and a ghost lane, half of them each way (only the local lane
    applied)."""
    matched = k10_matched(state, meas, partner, r)
    lone = torch.nonzero(partner < 0).flatten()
    ends = torch.nonzero(matched).flatten()
    pairs_lo = torch.unique(torch.minimum(ends, partner[ends].long()))
    m = pairs_lo.numel()
    k = min(200, lone.numel() // 2, ends.numel())
    require(k >= 2 and m >= 2,
            "K10: too few lone lanes or matched pairs for the hard cases")
    chain = partner.clone()
    chain[lone[:k]] = ends[:k].int()
    selfish = partner.clone()
    selfish[lone[k:2 * k]] = lone[k:2 * k].int()
    local = torch.ones_like(state.has_collided)
    local[partner[pairs_lo[: m // 2]].long()] = False  # the higher a ghost
    local[pairs_lo[m // 2:]] = False                   # the lower a ghost
    for label, p, loc in (
            (f"a chain k -> i <-> j, {k} lanes", chain, None),
            (f"{k} self-partners", selfish, None),
            (f"{m} pairs split local / ghost, {m // 2} and {m - m // 2} "
             f"each way", partner, local)):
        _, _, count, ulps, _, _ = check_k10_case(label, state, meas, p, r,
                                                 loc)
        print(f"K10 resolve_pairs ({label}): count {int(count) - 7}, mask "
              f"and staging exact, state {ulps} ulp from plain, the lanes "
              f"not applied to untouched {tag}")
        if loc is not None:
            require(int(count) - 7 == m, f"K10 ({label}): {int(count) - 7} "
                    f"lanes applied, not one a pair")


def check_resolve_pairs_graph(state, meas, search, r: float, dt: float, gen,
                              tag: str) -> None:
    """K10 recorded in a CUDA graph and replayed three times, the positions
    moved by 1-3 more drifts, the partners searched again and the paths
    and staging redrawn before each replay: every replay equals the twin
    on the same inputs (K10 keeps no scratch and takes nothing from the
    host that changes from call to call)."""
    dev = state.pos.device
    ss, sm = own(state), own(meas)
    partner = search(state.pos)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        collide.resolve_pairs(own(state), own(meas), partner, r,
                              count=count.clone())
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = kernels.launch_counts["resolve_pairs"]
    with torch.cuda.graph(graph, stream=side):
        collide.resolve_pairs(ss, sm, partner, r, count=count)
    require(kernels.launch_counts["resolve_pairs"] == before + 1,
            "K10: the capture recorded other than one launch")
    counts = []
    for k in range(1, 4):
        moved = dataclasses.replace(state,
                                    pos=state.pos + k * dt * state.vel)
        fresh, fresh_m = k10_inputs(moved, gen, meas.hist.shape[1] - 1)
        refill(ss, fresh)
        refill(sm, fresh_m)
        partner.copy_(search(fresh.pos))
        count.zero_()
        graph.replay()
        torch.cuda.synchronize()
        wc = torch.zeros_like(count)
        ws, wm, _ = collide.resolve_pairs_plain(
            own(fresh), own(fresh_m), partner, r, count=wc)
        exact("K10 count (graph replay)", count, wc)
        for f in ("pending_mask", "pending_vals"):
            exact(f"K10 {f} (graph replay)", getattr(sm, f), getattr(wm, f))
        exact("K10 has_collided (graph replay)", ss.has_collided,
              ws.has_collided)
        ulps = max(ulp_diff(getattr(ss, f), getattr(ws, f))
                   for f in ("pos", "vel", "paths"))
        require(ulps <= 2, f"K10 (graph replay): {ulps} ulp from plain")
        counts.append(int(wc))
    print(f"K10 resolve_pairs: one captured launch replayed 3 times on "
          f"positions moved by 1-3 more drifts, {counts} pairs: exact each "
          f"time, state within 2 ulp {tag}")


def k10_bound_bytes(state, partner, applied, local=None) -> int:
    """What the in-place K10 needs: the partner array read, each lane with
    a partner reads its partner's partner, a mutual pair's two rows of pos
    and vel read, a lane applied to reads its paths and has_collided (17
    bytes) and writes pos, vel, paths and has_collided (41), and stages 17
    bytes where its path was already broken; with ``local`` the mask of
    the applied lanes read and ``ok`` written for every lane."""
    n = partner.shape[0]
    has = partner >= 0
    safe = torch.where(has, partner, 0).long()
    idx = torch.arange(n, device=partner.device)
    mutual = has & (partner[safe] == idx) & (safe != idx)
    emits = applied & state.has_collided
    io = (4 * n + 4 * int(has.sum()) + 24 * int(mutual.sum())
          + 58 * int(applied.sum()) + 17 * int(emits.sum()))
    if local is not None:
        io += n + int(mutual.sum())
    return io


def time_resolve_pairs(state, meas, partner, r: float, err: float,
                       reps: int, tag: str, local=None, label="at 1M"):
    """K10's time in place on a copy of its inputs refilled before each
    call, net of that copy (median of three), beside the twin's; its bound
    restated for the in-place form from these inputs, the copying first
    version's printed beside it."""
    ts, tm = own(state), own(meas)
    count = torch.zeros((), dtype=torch.int32, device=partner.device)

    def reset():
        refill(ts, state)
        refill(tm, meas)

    ms, reset_ms, nets = net_ms(
        lambda: collide.resolve_pairs(ts, tm, partner, r, count=count,
                                      local_mask=local), reset, reps)
    plain_ms = timed_ms(lambda: collide.resolve_pairs_plain(
        own(state), own(meas), partner, r, count=count.clone(),
        local_mask=local), min(reps, 5))
    matched = (k10_matched(state, meas, partner, r) if local is None
               else collide.resolve_pairs_plain(
                   own(state), own(meas), partner, r, local_mask=local)[3])
    applied = matched if local is None else matched & local
    io = k10_bound_bytes(state, partner, applied, local)
    copying = tensor_bytes(state, partner, meas.pending_vals,
                           meas.pending_mask) * 2 - 4 * partner.shape[0]
    # ~20 float32 operations a mutual lane's test, ~70 an applied lane.
    ops = 20 * int(matched.sum()) + 70 * int(applied.sum())
    r_ = result(err, ms, plain_ms, io, ops)
    print(f"K10 resolve_pairs {label}: {ms!r} ms a call in place (the "
          f"median of {nets!r}, each net of the copy that restores the "
          f"inputs, {reset_ms!r} ms; the copying first version: "
          f"0.070-0.096 ms), plain {plain_ms!r} ms, bound "
          f"{r_['bound_ms']!r} ms ({r_['bound_by']}: "
          f"{int(applied.sum())} lanes applied to; the copying form's "
          f"{copying / HBM_BYTES_PER_S * 1e3!r} ms) {tag}")
    return r_


def slab_lanes(cfg, host_grid) -> int:
    """The staging rows of one of SLABS z-slabs of ``cfg``: its local and
    ghost lanes, the capacity the z-slab engine flushes them with."""
    plan = amt.parallel.make_shard_plan(amt.make_workload(cfg), SLABS,
                                        host_grid)
    return plan.shard_capacity + 2 * plan.halo_capacity


def k7_staging(meas, gen, density: float, scale: float = 1.2e-6):
    """``meas`` with a staging drawn from ``gen`` within its contract (a
    row whose mask is clear is zero), some values beyond the histogram's
    range, ``hist`` and ``path_sum`` drawn too."""
    n, dev = meas.pending_mask.shape[0], meas.pending_mask.device
    u = torch.rand((n, 5), generator=gen, device=dev)
    mask = u[:, 4] < density
    return dataclasses.replace(
        meas, pending_mask=mask,
        pending_vals=torch.where(mask[:, None], u[:, :4] * scale, 0.0),
        hist=torch.randint(0, 50, meas.hist.shape, generator=gen,
                           device=dev).float(),
        path_sum=u[:4, 0] * 1e-3)


def check_flush_case(label, meas, kernel, twin, mine=None):
    """A K7 entry, ``kernel(m)``, and its twin, ``twin(m)``, each on its
    own copy of the measurements (the kernel on ``mine`` if given,
    refilled from ``meas``): hist, counts and the cleared staging exact,
    path_sum within 1e-6 relative, the kernel's measurements the tensors
    it was given, none moved.  Returns (kernel output, twin output,
    path_sum's relative error)."""
    if mine is None:
        mine = own(meas)
    else:
        refill(mine, meas)
    ptrs = {f.name: getattr(mine, f.name).data_ptr()
            for f in dataclasses.fields(mine)}
    got = kernel(mine)
    want = twin(own(meas))
    same_tensors(got, mine, label)
    require(all(getattr(got, k).data_ptr() == v for k, v in ptrs.items()),
            f"{label}: a data_ptr moved")
    for f in ("hist", "path_count", "hist_drop_count", "pending_mask",
              "pending_vals"):
        exact(f"{label} {f}", getattr(got, f), getattr(want, f))
    rel = path_sum_rel(got, want)
    require(rel <= 1e-6, f"{label} path_sum: rel {rel}")
    return got, want, rel


def check_k7_case(label, meas, nb, hi, cap, mine=None):
    """K7's dense entry at capacity ``cap`` (see ``check_flush_case``)."""
    return check_flush_case(
        f"K7 ({label})", meas,
        lambda m: measure_ops.flush_hist(m, nb, hi, capacity=cap),
        lambda m: measure_ops.flush_hist_plain(m, nb, hi, capacity=cap),
        mine)


def check_flush_dense(after_k10, gen, cfg, host_grid, tag: str,
                      reps: int = 20):
    """K7's dense entry in place: on the staging K10 left at the sweep's
    capacity (some 100k events over 16,384: the look-back's cut), a dense
    staging over capacity 4096 (events dropped), capacity >= N (no cut),
    a slab's staging at its capacity of cap + 2 hcap, two calls in a row
    on the same tensors, and one launch captured in a CUDA graph and
    replayed three times on changed staging; then its time net of the
    copy that restores the inputs, beside the twin's."""
    n = after_k10.pending_mask.shape[0]
    nb, hi = cfg.engine.num_bins, cfg.engine.hist_range[1]
    require(not bool(after_k10.pending_vals[~after_k10.pending_mask].any()),
            "K7: an unstaged row of K10's staging is not zero")
    dense = k7_staging(after_k10, gen, 0.25)
    lanes = slab_lanes(cfg, host_grid)
    slab = k7_staging(Measurements.zeros(nb, torch.float32, lanes, "cuda"),
                      gen, 0.05)
    err = 0.0
    for label, m, cap in (
            ("staging after K10", after_k10, measure_ops.FLUSH_CAPACITY),
            ("dense, capacity 4096", dense, 4096),
            ("capacity >= N", dense, n),
            (f"a slab of {lanes} lanes, capacity {lanes}", slab, lanes)):
        got, want, rel = check_k7_case(label, m, nb, hi, cap)
        err = max(err, max_abs(got.path_sum, want.path_sum))
        events = int(m.pending_mask.sum())
        dropped = int(got.hist_drop_count) - int(m.hist_drop_count)
        require(dropped == (max(events - cap, 0) if m.pending_mask.shape[0]
                            > cap else 0), f"K7 ({label}): {dropped} dropped")
        print(f"K7 flush_hist ({label}): hist and counts exact, "
              f"events={events}, dropped={dropped}, path_sum rel err "
              f"{rel!r} (bound 1e-6), in place, data_ptrs unchanged {tag}")

    # Two calls in a row on the same tensors, the second on a new staging.
    mine = own(after_k10)
    check_k7_case("first of two calls", after_k10, nb, hi,
                  measure_ops.FLUSH_CAPACITY, mine)
    second = dataclasses.replace(
        k7_staging(after_k10, gen, 0.15), hist=mine.hist.clone(),
        path_sum=mine.path_sum.clone(), path_count=mine.path_count.clone(),
        hist_drop_count=mine.hist_drop_count.clone())
    check_k7_case("second of two calls", second, nb, hi,
                  measure_ops.FLUSH_CAPACITY, mine)
    print(f"K7 flush_hist: two calls in a row on the same tensors: exact "
          f"{tag}")
    check_flush_dense_graph(after_k10, gen, nb, hi, tag)

    # What the flush needs: the mask read, the staged rows read and
    # cleared with their mask bytes, hist and path_sum read and written;
    # four additions a staged event.
    count = int(after_k10.pending_mask.sum())
    io = n + 33 * count + 2 * (after_k10.hist.numel() * 4 + 16)
    ms = plain_ms = None
    if reps > 0:
        mine = own(after_k10)
        ms, reset_ms, nets = net_ms(
            lambda: measure_ops.flush_hist(mine, nb, hi),
            lambda: refill(mine, after_k10), reps)
        plain_ms = timed_ms(lambda: measure_ops.flush_hist_plain(
            own(after_k10), nb, hi), min(reps, 5))
        print(f"K7 flush_hist: {ms!r} ms a call in place (the median of "
              f"{nets!r}, each net of the copy that restores the "
              f"measurements, {reset_ms!r} ms; the four-launch copying "
              f"first version: 0.083-0.165 ms) {tag}")
    return result(err, ms, plain_ms, io, 4 * count)


def check_flush_dense_graph(meas, gen, nb, hi, tag: str) -> None:
    """K7's dense entry at the sweep's capacity (the look-back's cut)
    recorded in a CUDA graph and replayed three times, the staging redrawn
    before each replay: every replay equals the twin on the same inputs.
    One call on the capturing stream first allocates that stream's
    scratch."""
    dev = meas.pending_mask.device
    cap = measure_ops.FLUSH_CAPACITY
    static = own(meas)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        measure_ops.flush_hist(own(meas), nb, hi, capacity=cap)
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = kernels.launch_counts["flush_hist"]
    with torch.cuda.graph(graph, stream=side):
        measure_ops.flush_hist(static, nb, hi, capacity=cap)
    require(kernels.launch_counts["flush_hist"] == before + 1,
            "K7: the capture recorded other than one launch")
    counts = []
    for density in (0.005, 0.1, 0.3):
        fresh = k7_staging(meas, gen, density)
        fresh = dataclasses.replace(fresh, path_count=meas.path_count + 7)
        refill(static, fresh)
        graph.replay()
        torch.cuda.synchronize()
        want = measure_ops.flush_hist_plain(own(fresh), nb, hi, capacity=cap)
        for f in ("hist", "path_count", "hist_drop_count", "pending_mask",
                  "pending_vals"):
            exact(f"K7 {f} (graph replay)", getattr(static, f),
                  getattr(want, f))
        rel = path_sum_rel(static, want)
        require(rel <= 1e-6, f"K7 path_sum (graph replay): rel {rel}")
        counts.append(int(fresh.pending_mask.sum()))
    print(f"K7 flush_hist: one captured launch replayed 3 times with "
          f"{counts} events staged at capacity {cap}: exact each time {tag}")


def check_k2(label: str, pos, grid, valid=None):
    """K2 on ``pos`` exactly equal to its plain version; returns the
    kernel's outputs."""
    got = collide.bin_and_table(pos, grid, valid=valid)
    want = collide.bin_and_table_plain(pos, grid, valid=valid)
    for name, a, b in zip(("cell_id", "table", "pslot", "overflow"), got,
                          want):
        exact(f"K2 {name} ({label}, capacity {grid.capacity})", a, b)
    return got


def longest_segment(cell_id, grid) -> int:
    real = cell_id[cell_id < grid.num_cells].long()
    return int(torch.bincount(real, minlength=grid.num_cells).max())


def check_bin_and_table_hard(state, grids, dt: float, tag: str) -> None:
    """K2 exactly against its plain version where its table fill takes the
    long-segment path and where its kept scratch must carry over from call
    to call: 150 particles spread over the index range moved into one
    particle's cell (a segment of more than 100); 20,000 particles all in
    one cell; two calls in a row on different positions, then the first
    again, with the counts left zero between calls; one call recorded in a
    CUDA graph and replayed three times on positions moved by one, two and
    three more drifts (one call on the capturing stream first, as the
    wrapper asks).  At every capacity in ``grids``."""
    pos = state.pos
    n = pos.shape[0]
    crowd = pos.clone()
    spread = torch.arange(150, device=pos.device) * (n // 150) + 1
    crowd[spread] = pos[0]
    one_cell = pos[:20_000].clone()
    one_cell[:] = pos[0]
    moved = pos + dt * state.vel
    for g in grids:
        got = check_k2("150 more in one cell", crowd, g)
        longest = longest_segment(got[0], g)
        require(longest > 100, "K2: no segment of more than 100")
        got = check_k2("all in one cell", one_cell, g)
        require(longest_segment(got[0], g) == one_cell.shape[0],
                "K2: the one-cell case spans cells")
        first = check_k2("first of two calls", pos, g)
        check_k2("second of two calls", moved, g)
        again = collide.bin_and_table(pos, g)
        for a, b in zip(first, again):
            exact("K2 (the first positions again)", a, b)
        torch.cuda.synchronize()
        key = (pos.device.index, torch.cuda.current_stream().cuda_stream)
        require(int(collide._k2_counts[key].abs().sum()) == 0,
                "K2: the counts are not zero between calls")
        print(f"K2 bin_and_table capacity={g.capacity}: exact with a cell of "
              f"{longest} particles, with {one_cell.shape[0]} in one cell, "
              f"and over two calls in a row on different positions (counts "
              f"zero between calls) {tag}")
    check_bin_and_table_graph(pos, state.vel, dt, grids[0], tag)


def check_bin_and_table_graph(pos, vel, dt: float, grid, tag: str) -> None:
    """K2 recorded in a CUDA graph, replayed three times on moved
    positions: each replay equals the plain version."""
    static = pos.clone()
    side = torch.cuda.Stream(pos.device)
    side.wait_stream(torch.cuda.current_stream(pos.device))
    with torch.cuda.stream(side):
        collide.bin_and_table(static, grid)
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = kernels.launch_counts["bin_and_table"]
    scratches = (len(collide._k2_counts), len(collide._k2_work),
                 len(compact._scratch))
    with torch.cuda.graph(graph, stream=side):
        out = collide.bin_and_table(static, grid)
    require((len(collide._k2_counts), len(collide._k2_work),
             len(compact._scratch)) == scratches,
            "K2: the capture allocated a scratch")
    require(kernels.launch_counts["bin_and_table"] == before + 1,
            "K2: the capture recorded other than one call")
    overflow = []
    for k in (1, 2, 3):
        static.copy_(pos + (k * dt) * vel)
        graph.replay()
        torch.cuda.synchronize()
        want = collide.bin_and_table_plain(static, grid)
        for name, a, b in zip(("cell_id", "table", "pslot", "overflow"), out,
                              want):
            exact(f"K2 {name} (graph replay {k})", a, b)
        overflow.append(int(out[3]))
    print(f"K2 bin_and_table: one captured call replayed 3 times on "
          f"positions moved by 1-3 more drifts: exact each time (overflow "
          f"{overflow}) {tag}")


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
    state = init_ops.init_pore(cfg, gen, dev)
    state = dataclasses.replace(state, pos=state.pos + cfg.dt * state.vel)
    wl = amt.make_workload(cfg)
    _, grid = build_grids(wl, dev)
    return SimpleNamespace(cfg=cfg, dev=dev, gen=gen, state=state, grid=grid,
                           pcfg=pairs_config_for(wl), n=state.num_particles,
                           cr=cfg.physics.collision_range, dt=cfg.dt)


COMPACT_LENGTHS = (1, 255, 4_097, 1_000_003)


def check_compact(case, tag: str, reps: int):
    """K6, exactly: on masks of three densities at N, truncated and padded;
    at lengths around its tile and vector widths with every, no and some
    entries set, at size 0 and sizes below and above the count; on a view
    that is not 16-byte aligned; and over 100 calls in a row on one stream
    with changing masks and lengths, checked only afterwards (each call
    finds the status words the calls before it left).  Timed at the
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
    for length in COMPACT_LENGTHS:
        v = torch.rand(length, generator=case.gen, device=case.dev)
        sizes = set()
        for label, mask in (("all set", v >= 0), ("none set", v < 0),
                            ("density 0.3", v < 0.3)):
            count = int(mask.sum())
            for size in (0, max(count // 2, 1), count + 7):
                sizes.add(size)
                exact(f"K6 compact (length {length}, {label}, size {size})",
                      compact.compact_indices(mask, size, length),
                      compact.compact_indices_plain(mask, size, length))
        print(f"K6 compact length={length}: all, none and 0.3 of the "
              f"entries set, sizes {sorted(sizes)}: exact {tag}")
    whole = u < 0.2
    view = whole[5:]
    require(view.data_ptr() % 16 != 0 and view.is_contiguous(),
            "K6: the view is aligned")
    exact("K6 compact (unaligned view)",
          compact.compact_indices(view, n // 8, n),
          compact.compact_indices_plain(view, n // 8, n))
    calls = []
    for k in range(100):
        length = 1 + (k * 7_919_131) % n if k % 3 else 1 + k * 41
        mask = u[:length] < (0.002, 0.3, 0.95)[k % 3]
        size = (length // 7, 64, length + 3)[(k // 3) % 3]
        calls.append((mask, size, length))
    outs = [compact.compact_indices(*call) for call in calls]
    torch.cuda.synchronize()
    for k, (call, out) in enumerate(zip(calls, outs)):
        exact(f"K6 compact (call {k} of 100 in a row, length {call[2]}, "
              f"size {call[1]})", out, compact.compact_indices_plain(*call))
    print(f"K6 compact: an unaligned view, and 100 calls in a row on one "
          f"stream with lengths {min(c[2] for c in calls)}-"
          f"{max(c[2] for c in calls)}: exact {tag}")
    shared = max(measure_ops.FLUSH_CAPACITY, n // 64)
    check_compact_graph(u, shared, tag)
    mask = u < 3e-3
    # The library call: torch.nonzero gives the same ascending indices
    # (without the truncation and padding), and syncs to size its output.
    return result(
        0.0,
        maybe_timed(lambda: compact.compact_indices(mask, shared, n), reps),
        maybe_timed(lambda: compact.compact_indices_plain(mask, shared, n),
                    reps),
        n + 4 * shared, 0.0,
        maybe_timed(lambda: torch.nonzero(mask), reps))


def check_compact_graph(u: torch.Tensor, size: int, tag: str) -> None:
    """K6 recorded in a CUDA graph and replayed three times, the mask
    changed between replays: every replay equals the plain version (the
    kernel takes nothing from the host that changes from call to call, and
    leaves its scratch zeroed).  One call on the capturing stream before
    the capture allocates that stream's scratch, as the wrapper's docstring
    asks, so the capture records the launch and the output alone.  Between
    the first and the second replay a call on the same stream with more
    tiles than that scratch has words makes the wrapper take a larger one:
    the recorded one must stay alive, and the replays after it stay right."""
    n = u.shape[0]
    static = torch.zeros(n, dtype=torch.bool, device=u.device)
    side = torch.cuda.Stream(u.device)
    side.wait_stream(torch.cuda.current_stream(u.device))
    with torch.cuda.stream(side):
        compact.compact_indices(static, size, n)
    side.synchronize()
    scratches = len(compact._scratch)
    graph = torch.cuda.CUDAGraph()
    before = kernels.launch_counts["compact"]
    with torch.cuda.graph(graph, stream=side):
        out = compact.compact_indices(static, size, n)
    require(len(compact._scratch) == scratches,
            "K6: the capture allocated a scratch")
    require(kernels.launch_counts["compact"] == before + 1,
            "K6: the capture recorded other than one launch")
    key = (u.device.index, side.cuda_stream)
    recorded = compact._scratch[key]
    counts = []
    for density in (2e-3, 0.4, 0.02):
        if len(counts) == 1:
            longer = compact.TILE * (recorded.shape[0] + 3)
            big = torch.zeros(longer, dtype=torch.bool, device=u.device)
            big[::1_000_003] = True
            with torch.cuda.stream(side):
                got = compact.compact_indices(big, 64, longer)
            side.synchronize()
            exact("K6 compact (a longer call between replays)", got,
                  compact.compact_indices_plain(big, 64, longer))
            require(compact._scratch[key] is not recorded
                    and any(t is recorded for t in compact._retired),
                    "K6: the recorded scratch was not kept")
            require(int(recorded.abs().sum()) == 0,
                    "K6: the recorded scratch is not zero between calls")
            del big, got
            torch.cuda.empty_cache()
        static.copy_(u < density)
        graph.replay()
        torch.cuda.synchronize()
        exact(f"K6 compact (graph replay, density {density})", out,
              compact.compact_indices_plain(static, size, n))
        counts.append(int(static.sum()))
    print(f"K6 compact: one captured launch replayed 3 times with {counts} "
          f"entries set at size {size}, a call that outgrows the recorded "
          f"scratch in between: exact each time {tag}")


def check_rebuild_sweep(case, tag: str, reps: int):
    """K1, exactly, in four cases: at the pairs capacity (timed); at
    capacity 8 (cells spill, so some particles have no slot); with every
    third cell taken off the active list (its particles are unswept); and
    with every reach at its largest, half a cell (most emitters have more
    hits than top_k keeps)."""
    pcfg = case.pcfg
    max_reach = 0.5 * case.grid.cell_size
    reach, clipped = pairs_ops.reach_radii(
        case.state.vel, case.cr, case.dt, pcfg.rebuild_interval, max_reach)
    pos = case.state.pos
    cfg8 = dataclasses.replace(case.cfg, engine=dataclasses.replace(
        case.cfg.engine, cell_capacity=8))
    grid8 = build_grids(amt.make_workload(cfg8), case.dev)[1]
    rank = case.grid.active_rank.clone()
    rank[::3] = -1
    cut = dataclasses.replace(case.grid, active_rank=rank)
    timing = None
    for label, grid, rch in (
            ("pairs capacity", case.grid, reach),
            ("cells overflow", grid8, reach),
            ("a third of the cells inactive", cut, reach),
            ("reach of half a cell", case.grid,
             torch.full_like(reach, max_reach))):
        _, table, pslot, overflow = collide.bin_and_table(pos, grid)
        args = (pos, rch, table, pslot, grid, pcfg.top_k)
        got = collide.rebuild_sweep(*args)
        want = collide.rebuild_sweep_plain(*args)
        for name, a, b in zip(("cands", "unswept", "pos0", "reach0"), got,
                              want):
            exact(f"K1 {name} ({label})", a, b)
        cands = got[0]
        full = int((cands[:, -1] >= 0).sum())
        print(f"K1 rebuild_sweep capacity={grid.capacity}, {label}: exact; "
              f"{int((cands >= 0).sum())} candidates, {full} full rows, "
              f"{int(got[1].sum())} unswept, {int(overflow)} over capacity "
              f"{tag}")
        if label == "pairs capacity":
            timing = (maybe_timed(lambda: collide.rebuild_sweep(*args), reps),
                      maybe_timed(lambda: collide.rebuild_sweep_plain(*args),
                                  min(reps, 3)))
            io = tensor_bytes(pos, rch, table, pslot, grid.neighbors,
                              grid.active_rank, got)
            tests = neighbor_slots(table, pslot, grid, case.n, slice(13, 27))
        elif label == "cells overflow":
            require(int(overflow) > 0, "K1: capacity 8 did not spill")
        elif label == "a third of the cells inactive":
            require(int(got[1].sum()) > case.n // 4,
                    "K1: the cut active list left few particles unswept")
        else:
            require(full > case.n // 4, "K1: few rows saturate top_k")
    r = result(0.0, *timing, io, PAIR_TEST_OPS * tests)
    if reps > 0:
        print(f"K1 rebuild_sweep: {r['ms']!r} ms a call (the particle-"
              f"ordered first version: 3.51 ms), bound {r['bound_ms']!r} ms "
              f"({r['bound_by']}) {tag}")
    return r


def check_rebuild_sweep_graph(case, tag: str) -> None:
    """K1 recorded in a CUDA graph and replayed three times, the positions
    moved by 1-3 more drifts and binned again (K2) before each replay:
    every replay equals the twin on the same inputs (K1 keeps no scratch
    and takes nothing from the host that changes from call to call)."""
    pcfg, grid = case.pcfg, case.grid
    max_reach = 0.5 * grid.cell_size

    def inputs(pos):
        reach, _ = pairs_ops.reach_radii(case.state.vel, case.cr, case.dt,
                                         pcfg.rebuild_interval, max_reach)
        _, table, pslot, _ = collide.bin_and_table(pos, grid)
        return [pos, reach, table, pslot]

    static = [t.clone() for t in inputs(case.state.pos)]
    side = torch.cuda.Stream(case.dev)
    side.wait_stream(torch.cuda.current_stream(case.dev))
    with torch.cuda.stream(side):
        collide.rebuild_sweep(*static, grid, pcfg.top_k)
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = kernels.launch_counts["rebuild_sweep"]
    with torch.cuda.graph(graph, stream=side):
        out = collide.rebuild_sweep(*static, grid, pcfg.top_k)
    require(kernels.launch_counts["rebuild_sweep"] == before + 1,
            "K1: the capture recorded other than one launch")
    found = []
    for k in range(1, 4):
        fresh = inputs(case.state.pos + k * case.dt * case.state.vel)
        for dst, src in zip(static, fresh):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        want = collide.rebuild_sweep_plain(*fresh, grid, pcfg.top_k)
        for name, a, b in zip(("cands", "unswept", "pos0", "reach0"), out,
                              want):
            exact(f"K1 {name} (graph replay {k})", a, b)
        found.append(int((want[0] >= 0).sum()))
    print(f"K1 rebuild_sweep: one captured launch replayed 3 times on "
          f"positions moved by 1-3 more drifts, {found} candidates: exact "
          f"each time {tag}")


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
            io = tensor_bytes(args[:7], got)
            check_emit_pairs_graph(case, args, tag)
    r = result(0.0, *timing, io)
    if reps > 0:
        print(f"K5 emit_pairs: {r['ms']!r} ms a call (the six-launch first "
              f"version: 0.071-0.133 ms), bound {r['bound_ms']!r} ms "
              f"({r['bound_by']}) {tag}")
    return r


def check_emit_pairs_graph(case, args, tag: str) -> None:
    """K5 recorded in a CUDA graph and replayed three times on candidate
    rows thinned to 100%, 40% and 5%: each replay's list is shorter than
    the one the replay before left in the same outputs, so the pad must
    overwrite that longer tail; every replay equals the twin, and the
    look-back scratch is zero after each.  One call on the capturing
    stream first allocates that stream's scratch."""
    cands, rest = args[0], args[1:]
    static = cands.clone()
    side = torch.cuda.Stream(case.dev)
    side.wait_stream(torch.cuda.current_stream(case.dev))
    with torch.cuda.stream(side):
        pairs_ops.emit_pairs(static, *rest)
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = kernels.launch_counts["emit_pairs"]
    with torch.cuda.graph(graph, stream=side):
        out = pairs_ops.emit_pairs(static, *rest)
    require(kernels.launch_counts["emit_pairs"] == before + 1,
            "K5: the capture recorded other than one launch")
    scratch = compact._scratch[(cands.device.index, side.cuda_stream)]
    u = torch.rand(cands.shape[0], generator=case.gen, device=case.dev)
    cursors = []
    for keep in (1.0, 0.4, 0.05):
        static.copy_(torch.where((u < keep)[:, None], cands, -1))
        graph.replay()
        torch.cuda.synchronize()
        want = pairs_ops.emit_pairs_plain(static, *rest)
        for name, a, b in zip(("a", "b", "cursor", "hot", "pending1",
                               "overflow", "spill"), out, want):
            exact(f"K5 {name} (graph replay, {keep:.0%} of the rows)", a, b)
        require(int(scratch.abs().sum()) == 0,
                "K5: the look-back scratch is not zero after a call")
        cursors.append(int(want[2]))
    require(cursors[0] > cursors[1] > cursors[2],
            "K5: the replays' lists do not shrink")
    print(f"K5 emit_pairs: one captured launch replayed 3 times on lists of "
          f"{cursors} entries, each shorter than the tail the one before "
          f"left: exact each time (pad included), scratch zero after each "
          f"{tag}")


def own(obj):
    """``obj`` (a dataclass of tensors) with every tensor cloned: the
    in-place kernels and their twins are each given their own."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).clone()
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


def refill(dst, src) -> None:
    """Copy every tensor of ``src`` into the same field of ``dst``."""
    for f in dataclasses.fields(src):
        t = getattr(src, f.name)
        if isinstance(t, torch.Tensor):
            getattr(dst, f.name).copy_(t)


def same_tensors(got, given, label: str) -> None:
    """The in-place kernel returned the tensors it was given."""
    for f in dataclasses.fields(given):
        t = getattr(given, f.name)
        if isinstance(t, torch.Tensor):
            require(getattr(got, f.name).data_ptr() == t.data_ptr(),
                    f"{label}: {f.name} is not the tensor given")


def net_ms(call, reset, reps: int):
    """An in-place call's time on a fresh copy of its inputs each rep: the
    reset and the call timed together, less the reset timed alone in the
    same way.  The call is host code around microseconds of device work,
    so it moves with the host: the median of three such pairs, and the
    reset's time beside it."""
    def both():
        reset()
        call()

    pairs = sorted((timed_ms(both, reps) - alone, alone)
                   for alone in (timed_ms(reset, reps) for _ in range(3)))
    return pairs[1][0], pairs[1][1], [t for t, _ in pairs]


def k3_inputs(case):
    """The state one drift after the rebuild with paths and has_collided,
    and staging within its contract (a row whose mask is clear is zero),
    drawn from the case's Generator."""
    n, dev = case.n, case.dev
    state = case.state
    u = torch.rand((n, 6), generator=case.gen, device=dev)
    state = dataclasses.replace(
        state, pos=state.pos + case.dt * state.vel, paths=u[:, :4] * 2e-7,
        has_collided=u[:, 4] < 0.6)
    mask = u[:, 5] < 0.1
    meas = dataclasses.replace(
        Measurements.zeros(case.cfg.engine.num_bins, torch.float32, n, dev),
        pending_vals=torch.where(mask[:, None], u[:, :4].flip(1) * 1e-6,
                                 0.0),
        pending_mask=mask)
    return state, meas


def with_duplicates(plist, pos, cr: float):
    """(a, b): the list with up to 300 colliding entries appended after its
    cursor reversed, and the same entries once more as they are."""
    n = pos.shape[0]
    a, b = plist.a.clone(), plist.b.clone()
    live = int(plist.cursor)
    listed = (a[:live] < n) & (b[:live] < n)
    d = pos[b[:live].clamp(max=n - 1).long()] - pos[a[:live].clamp(
        max=n - 1).long()]
    hit = torch.nonzero(listed & ((d * d).sum(1) < cr * cr)).flatten()
    k = min(300, hit.numel(), (a.shape[0] - live) // 2)
    require(k > 0, "K3: no colliding entry to duplicate")
    hit = hit[:k]
    a[live:live + k], b[live:live + k] = plist.b[hit], plist.a[hit]
    a[live + k:live + 2 * k] = plist.a[hit]
    b[live + k:live + 2 * k] = plist.b[hit]
    return a, b, k


def check_k3_case(label, state, meas, a, b, cr, e_cap, **slab):
    """K3 and its twin, each on its own copy of the inputs: masks,
    counts, staging and counters exact, state within 2 ulp, and the
    kernel's state and measurements the tensors it was given; ``slab``
    holds the z-slab arguments (ids, local_mask) where given.  Returns
    (kernel outputs, max abs error, ulps)."""
    gs, gm = own(state), own(meas)
    got = pairs_ops.test_and_resolve(gs, gm, a, b, cr, e_cap, **slab)
    want = pairs_ops.test_and_resolve_plain(own(state), own(meas), a, b, cr,
                                            e_cap, **slab)
    (ks, km, kc, kmask), (ws, wm, wc, wmask) = got, want
    same_tensors(ks, gs, f"K3 ({label})")
    same_tensors(km, gm, f"K3 ({label})")
    exact(f"K3 n_collisions ({label})", kc, wc)
    exact(f"K3 collided ({label})", kmask, wmask)
    exact(f"K3 has_collided ({label})", ks.has_collided, ws.has_collided)
    for f in ("pending_mask", "pending_vals", "collision_count",
              "overflow_count"):
        exact(f"K3 {f} ({label})", getattr(km, f), getattr(wm, f))
    floats = [(ks.pos, ws.pos), (ks.vel, ws.vel), (ks.paths, ws.paths)]
    ulps = max(ulp_diff(x, y) for x, y in floats)
    # Stated bound: 2 ulp (both round every operation once, IEEE).
    require(ulps <= 2, f"K3 ({label}): {ulps} ulp from plain")
    return got, max(max_abs(x, y) for x, y in floats), ulps


def check_test_and_resolve(case, plist, tag: str, reps: int):
    """K3 one drift after the rebuild, with paths, has_collided and staging
    drawn from the Generator: at the configured event_capacity, at 64
    (events dropped) and with reversed and repeated duplicate entries
    colliding (exactly one event may write a pair in place).  Returns
    (result, state and measurements after the kernel)."""
    state, meas = k3_inputs(case)
    e_cap = case.pcfg.event_capacity
    dup_a, dup_b, k = with_duplicates(plist, state.pos, case.cr)
    err, after = 0.0, None
    for label, a, b, cap in (
            (f"event_capacity={e_cap}", plist.a, plist.b, e_cap),
            ("event_capacity=64", plist.a, plist.b, 64),
            (f"{k} colliding entries reversed and {k} repeated", dup_a,
             dup_b, e_cap)):
        (gs, gm, gc, gmask), e, ulps = check_k3_case(label, state, meas, a,
                                                     b, case.cr, cap)
        err = max(err, e)
        print(f"K3 test_and_resolve {label}: {int(gc)} pairs, events "
              f"dropped={int(gm.overflow_count)}; mask, count, staging and "
              f"counters exact, state {ulps} ulp from plain (bound 2), in "
              f"place {tag}")
        if cap == 64:
            require(int(gm.overflow_count) > 0, "K3: no events dropped")
        else:
            require(int(gc) > 0, "K3: no pair resolved")
        if label.startswith("event_capacity") and cap == e_cap:
            after = (gs, gm, gmask)
            resolved = 2 * int(gc)
    n = case.n
    args = (plist.a, plist.b, case.cr, e_cap)
    ts, tm = own(state), own(meas)

    def reset():
        refill(ts, state)
        refill(tm, meas)

    timing = None
    if reps > 0:
        ms, reset_ms, nets = net_ms(
            lambda: pairs_ops.test_and_resolve(ts, tm, *args), reset, reps)
        plain_ms = timed_ms(lambda: pairs_ops.test_and_resolve_plain(
            own(state), own(meas), *args), min(reps, 5))
        timing = (ms, plain_ms)
        print(f"K3 test_and_resolve: {ms!r} ms a call in place (the median "
              f"of {nets!r}, each net of the copy that restores the inputs, "
              f"{reset_ms!r} ms; the copying first version: 0.162-0.341 "
              f"ms) {tag}")
    # What the in-place form needs: the entries' a and b, each listed
    # particle's position once, the kept events' endpoints written and
    # read, the resolved particles' pos, vel, paths, has_collided and
    # staging read and written (42 bytes in, 59 out a particle), and the
    # collided mask; the test's operations on the listed entries and ~35
    # a resolved particle.
    a_, b_ = plist.a, plist.b
    listed = (a_ < n) & (b_ < n)
    particles = torch.unique(torch.cat([a_[listed], b_[listed]])).numel()
    d = state.pos[b_[listed].long()] - state.pos[a_[listed].long()]
    events = min(int(((d * d).sum(1) < case.cr * case.cr).sum()), e_cap)
    io = (8 * a_.shape[0] + 12 * particles + 16 * events
          + 101 * resolved + n)
    r = result(err, *(timing or (None, None)), io,
               PAIR_TEST_OPS * int(listed.sum()) + 35 * resolved)
    return r, after


def check_test_and_resolve_graph(case, plist, tag: str) -> None:
    """K3 recorded in a CUDA graph and replayed three times, the positions
    moved by one more drift and the staging redrawn before each replay:
    every replay equals the twin on the same inputs (the kernels take
    nothing from the host that changes from call to call and restore their
    scratch).  One call on the capturing stream first allocates that
    stream's scratch."""
    state, meas = k3_inputs(case)
    e_cap = case.pcfg.event_capacity
    ss, sm = own(state), own(meas)
    side = torch.cuda.Stream(case.dev)
    side.wait_stream(torch.cuda.current_stream(case.dev))
    with torch.cuda.stream(side):
        pairs_ops.test_and_resolve(own(state), own(meas), plist.a, plist.b,
                                   case.cr, e_cap)
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = kernels.launch_counts["test_and_resolve"]
    with torch.cuda.graph(graph, stream=side):
        out = pairs_ops.test_and_resolve(ss, sm, plist.a, plist.b, case.cr,
                                         e_cap)
    require(kernels.launch_counts["test_and_resolve"] == before + 1,
            "K3: the capture recorded other than one launch")
    pairs = []
    for k in range(1, 4):
        fresh, fresh_m = k3_inputs(case)
        fresh = dataclasses.replace(
            fresh, pos=fresh.pos + k * case.dt * fresh.vel)
        refill(ss, fresh)
        refill(sm, fresh_m)
        graph.replay()
        torch.cuda.synchronize()
        ws, wm, wc, wmask = pairs_ops.test_and_resolve_plain(
            own(fresh), own(fresh_m), plist.a, plist.b, case.cr, e_cap)
        exact("K3 n_collisions (graph replay)", out[2], wc)
        exact("K3 collided (graph replay)", out[3], wmask)
        for f in ("pending_mask", "pending_vals", "collision_count",
                  "overflow_count"):
            exact(f"K3 {f} (graph replay)", getattr(sm, f), getattr(wm, f))
        exact("K3 has_collided (graph replay)", ss.has_collided,
              ws.has_collided)
        ulps = max(ulp_diff(getattr(ss, f), getattr(ws, f))
                   for f in ("pos", "vel", "paths"))
        require(ulps <= 2, f"K3 (graph replay): {ulps} ulp from plain")
        pairs.append(int(wc))
    print(f"K3 test_and_resolve: one captured call replayed 3 times on "
          f"positions moved by 1-3 more drifts, {pairs} pairs: exact each "
          f"time, state within 2 ulp {tag}")


K4_FIELDS = ("a", "b", "cursor", "hot", "reach0", "overflow")


def check_research_dirty(case, plist, state, tag: str, reps: int):
    """K4, exactly, in place (the kernel and the twin each on its own
    clones of the list's four updated tensors), on a dirty set of
    research_capacity lanes drawn from the Generator -- every 41st lane the
    fill value, the table-dropped particles among the rest, 8 particles
    sped up to 40 km/s (their reach clips), half of all particles bumped --
    in four cases: as configured (timed); at append_capacity 64 (entries
    beyond the append budget are dropped); with the cursor 50 entries short
    of the list's end (entries beyond the list are dropped); and against
    planes whose every stored reach is half a cell (lists fill)."""
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
    dirty_idx[::41] = n
    live = int((dirty_idx < n).sum())
    bump = torch.rand(n, generator=case.gen, device=dev) < 0.5
    m_cap = plist.a.shape[0]
    cases = (
        ("as configured", pcfg, plist),
        ("append_capacity 64", dataclasses.replace(pcfg, append_capacity=64),
         plist),
        ("cursor 50 short of the end", pcfg, dataclasses.replace(
            plist, cursor=torch.full_like(plist.cursor, m_cap - 50))),
        ("stored reach of half a cell", pcfg, dataclasses.replace(
            plist, reach0=torch.full_like(plist.reach0,
                                          0.5 * grid.cell_size))),
    )

    def own_list(pl):
        """``pl`` with clones of the tensors K4 updates in place."""
        return dataclasses.replace(pl, a=pl.a.clone(), b=pl.b.clone(),
                                   hot=pl.hot.clone(),
                                   reach0=pl.reach0.clone())

    timing = None
    for label, p, pl in cases:
        args = (dirty_idx, bump, grid, p, case.cr, case.dt)
        want, wlost, wlat = pairs_ops.research_dirty_plain(
            moved, own_list(pl), *args)
        mine = own_list(pl)
        got, glost, glat = pairs_ops.research_dirty(moved, mine, *args)
        for f in K4_FIELDS:
            exact(f"K4 {f} ({label})", getattr(got, f), getattr(want, f))
        exact(f"K4 lost ({label})", glost, wlost)
        exact(f"K4 latent_per ({label})", glat, wlat)
        for f in ("a", "b", "hot", "reach0"):
            require(getattr(got, f).data_ptr() == getattr(mine, f).data_ptr(),
                    f"K4 in place: {f} is a copy")
        appended = int(got.cursor) - int(pl.cursor)
        rows = torch.bincount(got.a[int(pl.cursor):int(got.cursor)].long(),
                              minlength=1)
        print(f"K4 research_dirty {label}: exact in place; {live} dirty "
              f"of {dirty_idx.numel()} lanes ({dropped.numel()} "
              f"table-dropped), appended={appended} "
              f"hot={int(got.hot.sum())} latent={int(glat.sum())} "
              f"overflow={int(got.overflow)} lost={bool(glost)} "
              f"longest row={int(rows.max())} {tag}")
        if label == "as configured":
            require(appended > 0, "K4: the configured case found nothing")
            scratch = own_list(pl)

            def reset():
                # reach0 is all a repeated in-place call changes (hot, a and
                # b are written again with the same values).
                scratch.reach0.copy_(pl.reach0)

            # Each call on the list as the rebuild left it.
            timing = (None, None)
            if reps > 0:
                in_place_ms, reset_ms, nets = net_ms(
                    lambda: pairs_ops.research_dirty(moved, scratch, *args),
                    reset, reps)
                timing = (in_place_ms, timed_ms(
                    lambda: pairs_ops.research_dirty_plain(
                        moved, own_list(pl), *args), min(reps, 5)))
            appended0 = appended
        elif label == "stored reach of half a cell":
            require(int(rows.max()) == p.research_top_k and bool(glost),
                    "K4: no list filled")
        else:
            require(bool(glost), f"K4: {label} lost nothing")
    # What this dirty set needs: for each dirty particle its index, pos,
    # vel, slot and bump flag in and its latent count out, and for the
    # bumped ones among them reach0 read and written; the slot planes
    # (pos0, idx0, reach0: 20 bytes a slot) of the union of the dirty
    # particles' 27 neighbour rows, each row once; the appended entries.
    # No whole-plane copy is counted: the step path's form makes none.
    cap = grid.capacity
    live_idx = dirty_idx[dirty_idx < n].long()
    slot = plist.pslot0[live_idx]
    cells = (slot[slot < grid.num_cells * cap] // cap).long()
    rows = grid.neighbors[cells].long()
    occ = (plist.idx0 < n).sum(dim=1)
    bumped = int(bump[live_idx].sum())
    io = (8 * bumped + live_idx.numel() * (4 + 12 + 12 + 4 + 1 + 4)
          + torch.unique(rows).numel() * cap * 20 + 8 * appended0)
    r = result(0.0, *timing, io, PAIR_TEST_OPS * int(occ[rows].sum()))
    if reps > 0:
        print(f"K4 research_dirty: {r['ms']!r} ms a call in place (the "
              f"median of {nets!r}, each net of the copy that restores "
              f"reach0, {reset_ms!r} ms; the thread-a-lane first version, "
              f"copying: 0.326-0.337 ms), bound {r['bound_ms']!r} ms "
              f"({r['bound_by']}) {tag}")
    return r


def check_research_dirty_graph(case, plist, state, tag: str) -> None:
    """K4 recorded in a CUDA graph and replayed three times, the positions
    moved by 1-3 more drifts, a fresh dirty set and bump mask drawn and the
    list's four updated tensors, cursor and overflow restored before each
    replay: every replay equals the twin on the same inputs, in place."""
    n, dev, pcfg, grid = case.n, case.dev, case.pcfg, case.grid

    def dirty_set():
        perm = torch.randperm(n, generator=case.gen, device=dev)
        idx = perm[:pcfg.research_capacity].sort().values.to(torch.int32)
        idx[::41] = n
        return idx, torch.rand(n, generator=case.gen, device=dev) < 0.5

    ss, ls = own(state), own(plist)
    dirty, bump = dirty_set()
    args = (grid, pcfg, case.cr, case.dt)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        pairs_ops.research_dirty(own(state), own(plist), dirty, bump, *args)
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = kernels.launch_counts["research_dirty"]
    with torch.cuda.graph(graph, stream=side):
        got, lost, latent = pairs_ops.research_dirty(ss, ls, dirty, bump,
                                                     *args)
    require(kernels.launch_counts["research_dirty"] == before + 1,
            "K4: the capture recorded other than one launch")
    appended = []
    for k in range(1, 4):
        moved = dataclasses.replace(
            state, pos=state.pos + k * case.dt * state.vel)
        fresh_dirty, fresh_bump = dirty_set()
        refill(ss, moved)
        refill(ls, plist)
        dirty.copy_(fresh_dirty)
        bump.copy_(fresh_bump)
        graph.replay()
        torch.cuda.synchronize()
        want, wlost, wlat = pairs_ops.research_dirty_plain(
            own(moved), own(plist), fresh_dirty, fresh_bump, *args)
        for f in K4_FIELDS:
            exact(f"K4 {f} (graph replay {k})", getattr(got, f),
                  getattr(want, f))
        exact(f"K4 lost (graph replay {k})", lost, wlost)
        exact(f"K4 latent_per (graph replay {k})", latent, wlat)
        for f in ("a", "b", "hot", "reach0"):
            require(getattr(got, f).data_ptr() == getattr(ls, f).data_ptr(),
                    f"K4 (graph replay): {f} is a copy")
        appended.append(int(want.cursor) - int(plist.cursor))
    print(f"K4 research_dirty: one captured call replayed 3 times on "
          f"positions moved by 1-3 more drifts and fresh dirty sets, "
          f"{appended} entries appended: exact each time, in place {tag}")


def check_k7c_case(label, meas, idx, nb, hi):
    """K7's compacted entry on ``idx`` (see ``check_flush_case``)."""
    return check_flush_case(
        f"K7c ({label})", meas,
        lambda m: measure_ops.flush_hist_compacted(m, idx, nb, hi),
        lambda m: measure_ops.flush_hist_compacted_plain(m, idx, nb, hi))


def check_flush_compacted(case, meas, tag: str, reps: int):
    """K7's compacted entry on K3's staging: with the engine's shared
    compaction width (some staged events left out of event_idx, so they
    count as drops) and with every event listed."""
    n = case.n
    nb, hi = case.cfg.engine.num_bins, case.cfg.engine.hist_range[1]
    shared = max(measure_ops.FLUSH_CAPACITY, n // 64)
    count = int(meas.pending_mask.sum())
    require(not bool(meas.pending_vals[~meas.pending_mask].any()),
            "K7c: an unstaged row of K3's staging is not zero")
    err, timing = 0.0, (None, None)
    for size in (shared, count + 100):
        idx = compact.compact_indices(meas.pending_mask, size, n)
        got, want, rel = check_k7c_case(f"event_idx size {size}", meas, idx,
                                        nb, hi)
        err = max(err, max_abs(got.path_sum, want.path_sum))
        print(f"K7c flush_hist_compacted event_idx size={size}: hist and "
              f"counts exact, events={count}, "
              f"dropped={int(got.hist_drop_count)}, path_sum rel err "
              f"{rel!r} (bound 1e-6), in place {tag}")
        if size < count:
            require(int(got.hist_drop_count) > 0, "K7c: no event left out")
        elif reps > 0:
            mine = own(meas)
            ms, reset_ms, nets = net_ms(
                lambda: measure_ops.flush_hist_compacted(mine, idx, nb, hi),
                lambda: refill(mine, meas), reps)
            timing = (ms, timed_ms(
                lambda: measure_ops.flush_hist_compacted_plain(
                    own(meas), idx, nb, hi), min(reps, 5)))
            print(f"K7c flush_hist_compacted: {ms!r} ms a call in place "
                  f"(the median of {nets!r}, each net of the copy that "
                  f"restores the measurements, {reset_ms!r} ms; the "
                  f"copying first version: 0.126-0.225 ms) {tag}")
    # What the flush needs: the mask read, the staged rows read and
    # cleared with their mask bytes, event_idx, hist and path_sum read and
    # written; four additions a staged event.
    io = (n + 33 * count + 4 * shared
          + 2 * (meas.hist.numel() * 4 + 16))
    return result(err, *timing, io, 4 * count)


def check_flush_compacted_graph(case, meas, tag: str) -> None:
    """K7's compacted entry recorded in a CUDA graph and replayed three
    times, the staging redrawn and event_idx recompacted before each
    replay: every replay equals the twin on the same inputs.  One call on
    the capturing stream first allocates that stream's scratch."""
    n, dev = case.n, case.dev
    nb, hi = case.cfg.engine.num_bins, case.cfg.engine.hist_range[1]
    shared = max(measure_ops.FLUSH_CAPACITY, n // 64)
    static = own(meas)
    idx = compact.compact_indices(meas.pending_mask, shared, n)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        measure_ops.flush_hist_compacted(own(meas), idx, nb, hi)
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = kernels.launch_counts["flush_hist_compacted"]
    with torch.cuda.graph(graph, stream=side):
        measure_ops.flush_hist_compacted(static, idx, nb, hi)
    require(kernels.launch_counts["flush_hist_compacted"] == before + 1,
            "K7c: the capture recorded other than one launch")
    counts = []
    for density in (0.02, 0.1, 0.3):
        u = torch.rand((n, 5), generator=case.gen, device=dev)
        mask = u[:, 4] < density
        fresh = dataclasses.replace(
            meas, pending_mask=mask,
            pending_vals=torch.where(mask[:, None], u[:, :4] * 1.2e-6, 0.0),
            hist=meas.hist + float(len(counts)),
            path_count=meas.path_count + 7)
        refill(static, fresh)
        idx.copy_(compact.compact_indices(mask, shared, n))
        graph.replay()
        torch.cuda.synchronize()
        want = measure_ops.flush_hist_compacted_plain(own(fresh), idx, nb,
                                                      hi)
        for f in ("hist", "path_count", "hist_drop_count", "pending_mask",
                  "pending_vals"):
            exact(f"K7c {f} (graph replay)", getattr(static, f),
                  getattr(want, f))
        rel = path_sum_rel(static, want)
        require(rel <= 1e-6, f"K7c path_sum (graph replay): rel {rel}")
        counts.append(int(mask.sum()))
    print(f"K7c flush_hist_compacted: one captured launch replayed 3 times "
          f"with {counts} events staged at event_idx size {shared}: exact "
          f"each time {tag}")


def check_pairs_kernels(tag: str, particles: int = PARTICLES,
                        reps: int = 20) -> dict:
    """Phase 2, pairs side: K6, K1, K5, K3, K4 and K7c against their plain
    versions on the card."""
    case = pairs_case(particles)
    results = {"compact": check_compact(case, tag, reps),
               "rebuild_sweep": check_rebuild_sweep(case, tag, reps),
               "emit_pairs": check_emit_pairs(case, tag, reps)}
    check_rebuild_sweep_graph(case, tag)
    plist = pairs_ops.rebuild(
        case.state, case.grid, case.pcfg, case.cr, case.dt,
        pairs_ops.PairList.init(case.n, case.grid, case.pcfg, torch.float32,
                                case.dev))
    results["test_and_resolve"], (state, meas, _) = check_test_and_resolve(
        case, plist, tag, reps)
    check_test_and_resolve_graph(case, plist, tag)
    results["research_dirty"] = check_research_dirty(case, plist, state, tag,
                                                     reps)
    check_research_dirty_graph(case, plist, state, tag)
    results["flush_hist_compacted"] = check_flush_compacted(case, meas, tag,
                                                            reps)
    check_flush_compacted_graph(case, meas, tag)
    if reps > 0:
        print_times(results, case.n, tag)
    return results


# --------------------------------------------------------------------------
# Whole engines
# --------------------------------------------------------------------------


def check_against_cpu(tag: str, cfg=None, label=None, steps: int = 10,
                      **engine) -> None:
    """A slice on the card against the same slice on the CPU -- the plain
    versions, which tests/test_torch_engine.py and test_torch_cube.py hold
    to the JAX reference -- from one initial state with one set of per-step
    uniforms, at a small size (the pore at 20k unless ``cfg`` is given).
    Counts and the histogram must be equal; the state may differ by the
    cos/sin rounding of the two devices (a few ulp a step)."""
    label = label or engine.get("narrowphase", "sweep")
    if cfg is None:
        cfg = amt.temperature_pore_config(
            engine=amt.EngineConfig(steps_per_epoch=5, **engine)).scaled_to(
                20_000)
    cpu = amt.Simulation(amt.make_workload(cfg), device="cpu")
    gpu = amt.Simulation(amt.make_workload(cfg), device="cuda")
    state, meas, gen = cpu.init(SEED)
    uniforms = torch.rand((steps, state.num_particles, 2), generator=gen)

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


def run_slice(tag: str, names, **engine):
    """Phases 5 and 6: one main path, counted.  Returns (launch counts,
    pair collisions of the run)."""
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
    # The sweep step launches each of its wrappers once.
    if label == "sweep":
        for name in KERNELS:
            require(counts.get(name, 0) == STEPS,
                    f"sweep slice: {name} launched {counts.get(name, 0)} "
                    f"times in {STEPS} steps")
    # K8 is the step's whole per-particle stage: once a step.
    require(counts.get("pore_advance", 0) == STEPS,
            f"{label} slice: pore_advance launched "
            f"{counts.get('pore_advance', 0)} times in {STEPS} steps")
    # K13 is the pairs step's recapture and dirty masks: once a step there,
    # never in the sweep.
    want = STEPS if label == "pairs" else 0
    require(counts.get("post_pairs", 0) == want,
            f"{label} slice: post_pairs launched "
            f"{counts.get('post_pairs', 0)} times in {STEPS} steps")
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
    return counts, pairs


# --------------------------------------------------------------------------
# The ledger gate: the main path's per-step ledger against the JAX
# package's own 250-step ledger at the reference scale
# --------------------------------------------------------------------------

# The JAX package's ledger (scripts/parity_run.py: temperature_pore_config()
# at its 557,649 molecules, float32, seed 17, 250 steps); columns Momentum,
# EnergyCold, EnergyHot, one row a step.
LEDGER_CSV = "parity_momentum_energy.csv"
LEDGER_STEPS = 250
LEDGER_COLUMNS = (("Momentum", "momentum_z"), ("EnergyCold", "energy_cold"),
                  ("EnergyHot", "energy_hot"))
# The z-test of scripts/parity_run.py:69-79: |mean difference| under 4
# combined standard errors, and a ratio of standard deviations in 0.5-2.
LEDGER_Z = 4.0
LEDGER_STD_RATIO = (0.5, 2.0)


def read_ledger_csv(path) -> dict:
    """The reference ledger's columns as float64 numpy arrays."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return {col: np.array([float(r[col]) for r in rows])
            for col, _ in LEDGER_COLUMNS}


def ledger_z_test(ref, ours) -> tuple:
    """(z, std ratio, passed) of one ledger column against the reference's
    (scripts/parity_run.py:69-79; population standard deviations)."""
    r = np.asarray(ref, np.float64)
    o = np.asarray(ours, np.float64)[: len(r)]
    se = np.sqrt(r.std() ** 2 / len(r) + o.std() ** 2 / len(o))
    z = abs(o.mean() - r.mean()) / se if se > 0 else math.inf
    ratio = o.std() / r.std()
    lo, hi = LEDGER_STD_RATIO
    return float(z), float(ratio), bool(z < LEDGER_Z and lo < ratio < hi)


def check_ledger_gate(tag: str, n_shards=None) -> None:
    """The main path at the reference scale (temperature_pore_config() at
    its default 557,649 molecules, float32, cells, pairs with K=8, a
    histogram flush every step, seed 17) for 250 steps on the card -- on
    one card, or with ``n_shards`` the sharded pairs mode with every slab
    on the card; its momentum_z, energy_cold and energy_hot rows against
    the JAX package's ledger in parity_momentum_energy.csv by the
    reference's z-test.  The two runs draw from different generators, so
    they agree statistically, not step by step."""
    ref = read_ledger_csv(Path(__file__).resolve().parent / LEDGER_CSV)
    cfg = amt.temperature_pore_config(engine=amt.EngineConfig(
        dtype="float32", broadphase="cells", hist_flush_interval=1, **PAIRS))
    require(cfg.seed == SEED, f"ledger gate: config seed {cfg.seed}")
    if n_shards is None:
        sim = amt.Simulation(amt.make_workload(cfg), device="cuda")
        label = "ledger gate"
    else:
        sim = amt.ShardedSimulation(amt.make_workload(cfg),
                                    n_shards=n_shards)
        label = f"ledger gate, {n_shards} slabs"
    t0 = time.perf_counter()
    state, meas, metrics = sim.run(num_steps=LEDGER_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    meas = sim.finalize_measure(meas)
    n = cfg.num_molecules
    parts, failed = [], []
    for col, field in LEDGER_COLUMNS:
        ours = getattr(metrics, field).double().cpu().numpy()
        require(len(ours) == LEDGER_STEPS and len(ref[col]) == LEDGER_STEPS,
                f"{label}: {len(ours)} steps against {len(ref[col])}")
        z, ratio, ok = ledger_z_test(ref[col], ours)
        parts.append(f"{col} z={z!r} std ratio={ratio!r}")
        if not ok:
            failed.append(col)
    print(f"{label}: {'; '.join(parts)} (bounds z < {LEDGER_Z}, std "
          f"ratio in {LEDGER_STD_RATIO[0]}-{LEDGER_STD_RATIO[1]}) {tag}")
    print(f"{label}: N={n} steps={LEDGER_STEPS} seed={cfg.seed} pairs "
          f"K={sim.pcfg.rebuild_interval}, "
          f"collisions={int(meas.collision_count)} "
          f"err={int(meas.err_count)} overflow={int(meas.overflow_count)} "
          f"halo_trunc={int(meas.halo_trunc_count)}, {seconds!r} s against "
          f"{LEDGER_CSV} {tag}")
    require(not failed, f"{label}: {failed} outside the z-test's bounds")


# --------------------------------------------------------------------------
# K8: the fused drift/walls/recapture pass, and K11: the all-pairs search
# --------------------------------------------------------------------------

# Ledger bound: the kernel and the plain version sum the same terms in two
# different fixed orders; float32 sums of <= N terms differ by about
# log2(N) 2^-24 sum|term| (1.2e-6 at 1M), so 1e-5 of sum|term|.
LEDGER_REL = 1e-5
# State bound: 0 ulp is expected (both round each operation once, IEEE,
# and cosf/sinf are the non-fast-math functions torch.cos/torch.sin call);
# 2 ulp allows one ulp in cos or sin, carried into the re-emitted
# velocity.
K8_ULPS = 2


def energized_scale(before, after, masks: dict, mass: float) -> tuple:
    """(sum|term| of the ledger's sums, the lanes they sum over): the lanes
    of the energized cases 3-6 in the plain version's ``masks``, from
    their velocities ``before`` and ``after`` the wall cases."""
    hit = torch.zeros(before.shape[0], dtype=torch.bool, device=before.device)
    for name, m in masks.items():
        if name[0] in "3456":
            hit |= m
    v0, v1 = before[hit].double(), after[hit].double()
    return {"momentum_z": mass * float((v1[:, 2] - v0[:, 2]).abs().sum()),
            "energy": 0.5 * mass * float(((v1 * v1).sum(1)
                                          - (v0 * v0).sum(1)).abs().sum())
            }, int(hit.sum())


def ledger_rel(got, want, scale: dict, label: str) -> float:
    """The largest gap of K8's three ledger sums from the plain version's,
    as a share of their sum|term|; raises past LEDGER_REL."""
    worst = 0.0
    for f in ("momentum_z", "energy_hot", "energy_cold"):
        d = abs(float(getattr(got, f)) - float(getattr(want, f)))
        sc = scale["momentum_z" if f == "momentum_z" else "energy"]
        rel = d / sc if sc > 0 else d
        require(rel <= LEDGER_REL, f"{label} {f}: {rel} of sum|term| from "
                f"plain")
        worst = max(worst, rel)
    return worst


K8_WRITES = ("pos", "vel", "paths", "has_collided")


def k8_outputs(out) -> dict:
    """K8's outputs by name (the staging: every row)."""
    state, meas, ledger = out[:3]
    return {**{f: getattr(state, f) for f in K8_WRITES},
            "pending_vals": meas.pending_vals,
            "pending_mask": meas.pending_mask,
            **dict(zip(WallLedger._fields, ledger)), "recaptured": out[3],
            "recap_w": out[4], "speed_pre": out[5]}


def check_pore_advance(tag: str, particles: int = PARTICLES, steps: int = 16,
                       reps: int = 20, require_cases: bool = True) -> dict:
    """K8 against its plain version on the card, over ``steps`` steps of
    the pairs slice after its first 24: each step's state and uniforms go
    through both (K8 on copies, which it updates in place and returns),
    then the slice takes the step."""
    cfg = config(particles, **PAIRS)
    sim = amt.Simulation(amt.make_workload(cfg), device="cuda")
    wl = sim.workload
    state, meas, gen = sim.init(SEED)
    start = 24
    state, meas, _ = sim.run(start, state=state, measure=meas, generator=gen)
    n = state.num_particles
    mass = cfg.physics.mass
    cases = Counter()
    ulps, err, ledger_err, energized = 0, 0.0, 0.0, 0
    for i in range(steps):
        u = torch.rand((n, 2), generator=gen, device="cuda")
        masks = {}
        want = wl.advance_plain(state, meas, u, masks)
        ks, km = own(state), own(meas)
        got = wl.advance(ks, km, u)
        require(got[0] is ks and got[1] is km,
                "K8: not the state and measurements given")
        same_tensors(got[0], ks, "K8")
        same_tensors(got[1], km, "K8")
        again = wl.advance(own(state), own(meas), u)
        (ws, wm, wl_, wrec, wrw, wsp), (gs, gm, gl, grec, grw, gsp) = want, got
        for name, m in masks.items():
            cases[name] += int(m.sum())
        floats = [(gs.pos, ws.pos), (gs.vel, ws.vel), (gs.paths, ws.paths)]
        ulps = max(ulps, *(ulp_diff(a, b) for a, b in floats))
        err = max(err, *(max_abs(a, b) for a, b in floats))
        for name, a, b in (("has_collided", gs.has_collided, ws.has_collided),
                           ("pending_vals", gm.pending_vals, wm.pending_vals),
                           ("pending_mask", gm.pending_mask, wm.pending_mask),
                           ("recap_w", grw, wrw), ("speed_pre", gsp, wsp),
                           ("recaptured", grec, wrec),
                           ("wall_hits", gl.wall_hits, wl_.wall_hits),
                           ("errs", gl.errs, wl_.errs)):
            exact(f"K8 {name} (step {i})", a, b.to(a.dtype))
        scale, hits = energized_scale(state.vel, ws.vel, masks, mass)
        energized += hits
        ledger_err = max(ledger_err, ledger_rel(gl, wl_, scale,
                                                f"K8 (step {i})"))
        g, a = k8_outputs(got), k8_outputs(again)
        for name in g:
            require(torch.equal(g[name], a[name]),
                    f"K8 {name}: two launches differ")
        state, meas, _ = sim.run(1, state=state, measure=meas,
                                 start_step=start + i, draw=lambda _: u)
    require(ulps <= K8_ULPS, f"K8: state {ulps} ulp from plain")
    groups = Counter()
    for name, count in cases.items():
        groups[name[0]] += count
    print(f"K8 pore_advance: {steps} steps at N={n}; particles per case "
          f"(plain masks) {dict(sorted(cases.items()))} {tag}")
    print(f"K8 pore_advance: state {ulps} ulp from plain (bound {K8_ULPS}), "
          f"max abs err {err!r}; masks, staging, hits, errs, recaptures and "
          f"speed_pre exact; in place (the state and staging given, "
          f"returned); ledger within {ledger_err!r} of sum|term| (bound "
          f"{LEDGER_REL}); two launches bitwise equal {tag}")
    if require_cases:
        for g in "123456":
            require(groups[g] > 0, f"K8: case {g} took no particle")
    u = torch.rand((n, 2), generator=gen, device="cuda")
    # The bound in place (counts/k8.py): pos, vel, paths and has_collided
    # read (41 bytes a particle), pos and paths written (the drift moves
    # every particle: 28), recap_w and speed_pre written (5); a wall case's
    # lanes also write vel, has_collided and their staging (30 bytes) and,
    # energized, read their uniforms (8).
    hits = sum(cases.values()) // steps
    in_place = n * (41 + 28 + 5) + 30 * hits + 8 * energized // steps
    out = {"pore_advance": result(
        err, None, maybe_timed(lambda: wl.advance_plain(state, meas, u),
                               min(reps, 3)),
        in_place, k8.OPS_PER_PARTICLE * n)}
    print(f"K8 pore_advance: bound in place {out['pore_advance']['bound_ms']!r}"
          f" ms (bytes: {in_place} at N={n}, {hits} wall-case lanes a step) "
          f"{tag}")
    if reps > 0:
        out["pore_advance"]["ms"] = time_pore_advance(wl, state, meas, u,
                                                      reps, tag)
        print_times(out, n, tag)
    return out


def time_pore_advance(wl, state, meas, u, reps: int, tag: str) -> float:
    """K8's time a call in place: the wrapper by CUDA events on copies
    reset before each call (``net_ms``, the median of three), and its
    device time and launches a call (torch.profiler).  Returns the ms."""
    ks, km = own(state), own(meas)

    def reset():
        for f in K8_WRITES:
            getattr(ks, f).copy_(getattr(state, f))
        km.pending_vals.copy_(meas.pending_vals)
        km.pending_mask.copy_(meas.pending_mask)

    def call():
        wl.advance(ks, km, u)

    ms, reset_ms, spread = net_ms(call, reset, reps)
    device_us, launches = device_per_call(call, reset)
    print(f"K8 pore_advance at N={state.num_particles}: {ms!r} ms a call in "
          f"place (median of {spread!r}, net of a {reset_ms!r} ms reset), "
          f"device {device_us!r} us in {launches!r} launches a call {tag}")
    return ms


def time_pore_advance_at(tag: str, particles: int, reps: int = 20) -> None:
    """K8 in place at ``particles`` (the 10M cell's size): the pairs run's
    state after 8 steps, its bound from one plain step's wall cases."""
    cfg = config(particles, **PAIRS)
    sim = amt.Simulation(amt.make_workload(cfg), device="cuda")
    wl = sim.workload
    state, meas, gen = sim.init(SEED)
    state, meas, _ = sim.run(8, state=state, measure=meas, generator=gen)
    del sim
    n = state.num_particles
    u = torch.rand((n, 2), generator=gen, device="cuda")
    masks = {}
    wl.advance_plain(state, meas, u, masks)
    hits = sum(int(m.sum()) for m in masks.values())
    energized = sum(int(m.sum()) for k, m in masks.items() if k[0] in "3456")
    del masks
    torch.cuda.empty_cache()
    ms = time_pore_advance(wl, state, meas, u, reps, tag)
    bound_ms, _ = k8.bound_ms(n, hits, energized)
    print(f"K8 pore_advance at N={n}: bound in place {bound_ms!r} ms "
          f"(counts/k8.py; {hits} wall-case lanes): {100 * bound_ms / ms!r}% "
          f"of it by the wrapper's time {tag}")


def check_pore_advance_in_place(tag: str, particles: int = PARTICLES,
                                audit: bool = False,
                                extra_rows: int = 0) -> None:
    """K8 in place against its plain twin run on copies, on the pairs
    slice's state after 24 steps, with the audit on or off and
    ``extra_rows`` more staging rows than particles (a slab's ghost rows,
    filled with draws): state, staging, masks, counts and the audit's
    counts bitwise, the ledger within LEDGER_REL of sum|term|; K8 returns
    and updates the tensors it was given and leaves the extra rows as they
    were."""
    cfg = config(particles, **PAIRS)
    sim = amt.Simulation(amt.make_workload(cfg), device="cuda")
    wl = sim.workload
    state, meas, gen = sim.init(SEED)
    state, meas, _ = sim.run(24, state=state, measure=meas, generator=gen)
    n = state.num_particles
    if extra_rows:
        ghost = torch.rand((extra_rows, 4), generator=gen, device="cuda")
        meas = dataclasses.replace(
            meas, pending_vals=torch.cat([meas.pending_vals, ghost]),
            pending_mask=torch.cat([meas.pending_mask, ghost[:, 0] > 0.5]))
    u = torch.rand((n, 2), generator=gen, device="cuda")
    missed = [torch.zeros(10, dtype=torch.int32, device="cuda")
              if audit else None for _ in range(2)]
    masks = {}
    want = wl.advance_plain(own(state), own(meas), u, masks,
                            missed=missed[0])
    ks, km = own(state), own(meas)
    given = {**{f: getattr(ks, f) for f in K8_WRITES},
             "pending_vals": km.pending_vals, "pending_mask": km.pending_mask}
    got = wl.advance(ks, km, u, missed=missed[1])
    require(got[0] is ks and got[1] is km,
            "K8: not the state and measurements given")
    for name, t in given.items():
        require(k8_outputs(got)[name].data_ptr() == t.data_ptr(),
                f"K8 {name}: not the tensor given")
    g, w = k8_outputs(got), k8_outputs(want)
    for name in g:
        if name in ("momentum_z", "energy_hot", "energy_cold"):
            continue
        require(bits_equal(g[name], w[name].to(g[name].dtype)),
                f"K8 {name}: in place != the plain version on copies")
    scale, _ = energized_scale(state.vel, want[0].vel, masks,
                               cfg.physics.mass)
    rel = ledger_rel(got[2], want[2], scale, "K8 in place")
    if audit:
        exact("K8 audit counts in place", missed[1], missed[0])
    if extra_rows:
        require(bits_equal(km.pending_vals[n:], meas.pending_vals[n:])
                and torch.equal(km.pending_mask[n:], meas.pending_mask[n:]),
                "K8: a staging row past the particles changed")
    changed = int((state.vel != ks.vel).any(1).sum())
    print(f"K8 pore_advance in place at N={n}, audit "
          f"{'on' if audit else 'off'}, {extra_rows} staging rows past the "
          f"particles: every output bitwise the plain version's on copies, "
          f"ledger within {rel!r} of sum|term|; {changed} rows of vel "
          f"rewritten; the tensors given returned, the rows past n as they "
          f"were {tag}")


def check_pore_advance_graph(tag: str, particles: int = PARTICLES) -> None:
    """K8 recorded in a CUDA graph and replayed three times on the pairs
    slice's state after 24, 25 and 26 steps with fresh uniforms, refilled
    into the captured inputs (which it updates in place): every replay's
    outputs bitwise those of a launch outside the graph on copies of the
    same inputs (K8 keeps no scratch; its constants are made at its first
    call, before the capture)."""
    cfg = config(particles, **PAIRS)
    sim = amt.Simulation(amt.make_workload(cfg), device="cuda")
    wl = sim.workload
    state, meas, gen = sim.init(SEED)
    state, meas, _ = sim.run(24, state=state, measure=meas, generator=gen)
    n = state.num_particles
    u = torch.rand((n, 2), generator=gen, device="cuda")
    ss, sm, su = own(state), own(meas), u.clone()
    side = torch.cuda.Stream(state.pos.device)
    side.wait_stream(torch.cuda.current_stream(state.pos.device))
    with torch.cuda.stream(side):
        wl.advance(ss, sm, su)
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = kernels.launch_counts["pore_advance"]
    with torch.cuda.graph(graph, stream=side):
        out = wl.advance(ss, sm, su)
    require(kernels.launch_counts["pore_advance"] == before + 1,
            "K8: the capture recorded other than one launch")
    require(out[0] is ss and out[1] is sm,
            "K8: the capture returned other than the state and staging given")
    hits = []
    for k in range(1, 4):
        state, meas, _ = sim.run(1, state=state, measure=meas,
                                 generator=gen, start_step=23 + k)
        u = torch.rand((n, 2), generator=gen, device="cuda")
        refill(ss, state)
        refill(sm, meas)
        su.copy_(u)
        graph.replay()
        want = wl.advance(own(state), own(meas), u)
        torch.cuda.synchronize()
        w = k8_outputs(want)
        for name, t in k8_outputs(out).items():
            require(torch.equal(t, w[name]),
                    f"K8 {name} (graph replay {k}): differs from a launch")
        hits.append(int(want[2].wall_hits))
    print(f"K8 pore_advance: one captured launch replayed 3 times on the "
          f"states after 24-26 steps at N={n}, {hits} wall hits: every "
          f"output bitwise that of a launch outside the graph {tag}")


# --------------------------------------------------------------------------
# K13: the pairs step's post-pairs recapture and dirty masks
# --------------------------------------------------------------------------

# Rows moved into the recapture's branches and onto their edges, as
# fractions of the pore's sizes: (x, y, z, conditions taken).  z is a
# fraction of the open-air height ``oah`` from a base: 0 (the bottom),
# "h" (the top), "gap" (the gap's middle), "cb" / "ct" (the middle of the
# bottom and the top coated band); x and y are fractions of a radius
# (``r_oa``, ``gap``, ``mid``: half-way between the coated and the gap
# radius).  Special values: "-0" (signed zero), "nan", "inf", and "oah",
# "h-oah", "gb" for those z exactly.
PLANTED = (
    ((0.5, "mid"), (0.0, "mid"), (-0.3, 0), 1),         # z < 0
    ((0.0, "mid"), (0.5, "mid"), (0.3, "h"), 1),        # z > h
    ((1.2, "r_oa"), (0.0, "r_oa"), (0.5, 0), 1),        # r > r_oa
    ((-0.8, "r_oa"), (0.8, "r_oa"), (0.5, 0), 1),
    ((1.2, "r_oa"), (0.0, "r_oa"), (-0.1, 0), 2),       # z < 0, r > r_oa
    ((0.0, "r_oa"), (-1.5, "r_oa"), (0.1, "h"), 2),     # z > h, r > r_oa
    ((1.1, "gap"), (0.0, "gap"), (0.0, "gap"), 1),      # the gap, r > gap
    ((1.0, "mid"), (0.0, "mid"), (0.0, "cb"), 1),       # coated, r > rc
    ((0.0, "mid"), (1.0, "mid"), (0.0, "ct"), 1),
    ((1.1, "gap"), (0.0, "gap"), (0.0, "cb"), 1),       # coated, r > gap
    ((2.0, "r_oa"), (0.0, "r_oa"), (0.0, "gap"), 1),    # r > r_oa first
    ((1.1, "gap"), (0.0, "gap"), (-0.2, 0), 1),         # z < 0 only
    ((1.1, "gap"), (0.0, "gap"), (0.2, "h"), 1),        # z > h only
    (("-0", None), ("-0", None), (-0.5, 0), 1),         # signed zeros
    ((1.2, "r_oa"), (0.0, "r_oa"), ("-0", None), 1),    # z = -0: r only
    (("inf", None), (0.0, "r_oa"), (0.5, 0), 1),
    ((1.0, "mid"), (0.0, "mid"), (0.0, "gap"), 0),      # stay: the gap
    ((0.0, "r_oa"), (0.0, "r_oa"), (0.0, 0), 0),        # z = 0
    ((0.0, "r_oa"), (0.0, "r_oa"), (0.0, "h"), 0),      # z = h
    ((1.1, "gap"), (0.0, "gap"), ("oah", None), 0),     # z = oah
    ((1.1, "gap"), (0.0, "gap"), ("h-oah", None), 0),   # z = h - oah
    ((1.0, "mid"), (0.0, "mid"), ("gb", None), 0),      # z = gap bottom
    (("nan", None), (0.0, "r_oa"), (0.5, 0), 0),        # moved, not taken
)


def planted_rows(geom) -> tuple:
    """(the PLANTED rows as a float64 (rows, 3) array, the recapture
    conditions they take in all)."""
    h, oah = geom.total_height, geom.open_air_height
    radii = {"r_oa": geom.open_air_radius, "gap": geom.gap_radius,
             "mid": 0.5 * (geom.pore_coated_radius + geom.gap_radius)}
    bases = {0: 0.0, "h": h,
             "gap": 0.5 * (geom.gap_bottom + geom.gap_top),
             "cb": 0.5 * (oah + geom.gap_bottom),
             "ct": 0.5 * (geom.gap_top + h - oah)}
    special = {"-0": -0.0, "nan": math.nan, "inf": math.inf, "oah": oah,
               "h-oah": h - oah, "gb": geom.gap_bottom}

    def coord(v, unit, scale):
        if isinstance(v, str):
            return special[v]
        return v * scale[unit] if unit in scale else v

    rows = []
    for (x, rx), (y, ry), (z, base), _ in PLANTED:
        zv = (special[z] if isinstance(z, str)
              else bases[base] + z * oah)
        rows.append((coord(x, rx, radii), coord(y, ry, radii), zv))
    return np.array(rows), sum(r[3] for r in PLANTED)


def post_pairs_case(particles: int, seed: int, device, energized=True):
    """The inputs of the pairs step's post-pairs stage at ``particles``:
    (workload, state, measure, plist, speed_pre, collided, recap_w).  The
    pore's initial state with ``planted_rows`` spread through it (the same
    rows again every 997 particles), hot, pending1, collided, recap_w and
    the staging mask drawn from ``seed``, and speed_pre the state's speed
    but where a draw moves it one ulp up or down."""
    cfg = config(particles, **PAIRS)
    if not energized:
        cfg = amt.PoreConfig(engine=cfg.engine).scaled_to(particles)
    wl = amt.make_workload(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    state = wl.init_fn(gen, device)
    n = state.num_particles
    rows, _ = planted_rows(cfg.geometry)
    planted = torch.as_tensor(rows, dtype=state.pos.dtype, device=device)
    at = torch.arange(0, n, 997, device=device)[:, None] + torch.arange(
        len(rows), device=device)
    at = at[at < n].reshape(-1)
    pos = state.pos.clone()
    pos[at] = planted[torch.arange(at.numel(), device=device) % len(rows)]
    state = dataclasses.replace(state, pos=pos)

    def draw(share):
        return torch.rand(n, generator=gen, device=device) < share

    speed = measure_ops.speed(state.vel)
    up = torch.nextafter(speed, torch.full_like(speed, math.inf))
    down = torch.nextafter(speed, torch.zeros_like(speed))
    speed_pre = torch.where(draw(0.03), up, torch.where(draw(0.03), down,
                                                        speed))
    measure = Measurements.zeros(
        cfg.engine.num_bins, cfg.engine.torch_dtype, num_particles=n,
        device=device)
    measure = dataclasses.replace(measure, pending_mask=draw(0.1))
    _, grid = build_grids(wl, device)
    plist = pairs_ops.PairList.init(n, grid, pairs_config_for(wl),
                                    cfg.engine.torch_dtype, device)
    plist = dataclasses.replace(plist, hot=draw(0.05), pending1=draw(0.02))
    return wl, state, measure, plist, speed_pre, draw(0.03), draw(0.01)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal to the bit (NaN included) and of one dtype and shape."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


POST_PAIRS_FIELDS = ("bump", "dirty", "shared", "oob_after_pairs",
                     "latent_full", "dirty_count", "teleports")


def post_pairs_outputs(out) -> dict:
    """Every output of a ``PostPairs`` by name: pos, hot, pending1 and
    POST_PAIRS_FIELDS."""
    return {"pos": out.state.pos, "hot": out.plist.hot,
            "pending1": out.plist.pending1,
            **{f: getattr(out, f) for f in POST_PAIRS_FIELDS}}


def check_post_pairs(tag: str, particles: int = PARTICLES,
                     reps: int = 20) -> dict:
    """K13 against its twin on the card, on ``post_pairs_case``: every
    output and count bitwise, in place (the state, the list, pos, hot and
    pending1 are the objects given; no row of pos but the twin's moved
    ones changes), two launches bitwise equal; then its wrapper's time
    (CUDA events, in place on fresh copies), its device time and launches
    a call (torch.profiler), the twin's time and the bound."""
    from argon_monte_carlo_tpu_torch.ops import post_pairs as post_ops
    wl, state, meas, plist, sp, col, rw = post_pairs_case(particles, SEED,
                                                          "cuda")
    n = state.num_particles
    want = post_ops.post_pairs_plain(wl.post_pairs, own(state), meas,
                                     own(plist), sp, col, rw)
    ks, kp = own(state), own(plist)
    given = (ks.pos.data_ptr(), kp.hot.data_ptr(), kp.pending1.data_ptr())
    before = kernels.launch_counts["post_pairs"]
    got = wl.post_pairs_stage(ks, meas, kp, sp, col, rw)
    require(kernels.launch_counts["post_pairs"] == before + 1,
            "K13: other than one launch")
    require(got.state is ks and got.plist is kp,
            "K13: not the state and list given")
    require((got.state.pos.data_ptr(), got.plist.hot.data_ptr(),
             got.plist.pending1.data_ptr()) == given,
            "K13: pos, hot or pending1 is not the tensor given")
    g, w = post_pairs_outputs(got), post_pairs_outputs(want)
    for name in g:
        require(bits_equal(g[name], w[name]),
                f"K13 {name}: kernel != plain")
    moved_rows = int((state.pos.view(torch.int32)
                      != want.state.pos.view(torch.int32)).any(1).sum())
    again = wl.post_pairs_stage(own(state), meas, own(plist), sp, col, rw)
    for name, t in post_pairs_outputs(again).items():
        require(bits_equal(t, g[name]), f"K13 {name}: two launches differ")
    counts = {f: int(getattr(got, f)) for f in POST_PAIRS_FIELDS[3:]}
    require(counts["oob_after_pairs"] > 0 and counts["teleports"] > 0,
            "K13: no particle recaptured")
    print(f"K13 post_pairs: N={n}, {moved_rows} rows of pos moved in place "
          f"(pos, hot, pending1 the tensors given), counts {counts}: every "
          f"output and count bitwise the plain version's; two launches "
          f"bitwise equal {tag}")
    if reps <= 0:
        return {}

    ks, kp = own(state), own(plist)

    def reset():
        ks.pos.copy_(state.pos)
        kp.hot.copy_(plist.hot)
        kp.pending1.copy_(plist.pending1)

    def call():
        wl.post_pairs_stage(ks, meas, kp, sp, col, rw)

    ms, reset_ms, spread = net_ms(call, reset, reps)
    device_us, launches = device_per_call(call, reset)
    plain_ms = timed_ms(lambda: post_ops.post_pairs_plain(
        wl.post_pairs, state, meas, plist, sp, col, rw), max(3, reps // 5))
    r = result(0.0, ms, plain_ms, 35 * n)
    print(f"K13 post_pairs at N={n}: {ms!r} ms a call in place (median of "
          f"{spread!r}, net of a {reset_ms!r} ms reset), device "
          f"{device_us!r} us in {launches!r} launches a call; plain "
          f"{plain_ms!r} ms; bound {r['bound_ms']!r} ms (bytes: 35 a "
          f"particle, counts/k13.py) {tag}")
    return {"post_pairs": r}


def check_post_pairs_graph(tag: str, particles: int = PARTICLES) -> None:
    """K13 recorded in a CUDA graph after one call on the capturing stream,
    and replayed three times on inputs drawn from three seeds: every
    replay's outputs bitwise those of a launch outside the graph on the
    same inputs."""
    wl, state, meas, plist, sp, col, rw = post_pairs_case(particles, SEED,
                                                          "cuda")
    ss, sm, sl = own(state), own(meas), own(plist)
    sp_, col_, rw_ = sp.clone(), col.clone(), rw.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        wl.post_pairs_stage(own(state), meas, own(plist), sp, col, rw)
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = kernels.launch_counts["post_pairs"]
    with torch.cuda.graph(graph, stream=side):
        out = wl.post_pairs_stage(ss, sm, sl, sp_, col_, rw_)
    require(kernels.launch_counts["post_pairs"] == before + 1,
            "K13: the capture recorded other than one launch")
    teleports = []
    for k in range(1, 4):
        _, s2, m2, l2, p2, c2, r2 = post_pairs_case(particles, SEED + k,
                                                    "cuda")
        refill(ss, s2)
        refill(sm, m2)
        refill(sl, l2)
        sp_.copy_(p2)
        col_.copy_(c2)
        rw_.copy_(r2)
        graph.replay()
        want = wl.post_pairs_stage(own(s2), m2, own(l2), p2, c2, r2)
        torch.cuda.synchronize()
        w = post_pairs_outputs(want)
        for name, t in post_pairs_outputs(out).items():
            require(bits_equal(t, w[name]),
                    f"K13 {name} (graph replay {k}): differs from a launch")
        teleports.append(int(want.teleports))
    print(f"K13 post_pairs: one captured launch replayed 3 times on inputs "
          f"of 3 seeds at N={state.num_particles}, {teleports} teleports: "
          f"every output bitwise that of a launch outside the graph {tag}")


def cube_config(particles=None, **engine) -> amt.CubeConfig:
    """The cube at its published density, in a box scaled to hold
    ``particles`` (the published 100 nm box when None)."""
    geom = amt.CubeGeometry()
    if particles is not None:
        side = geom.lx * (particles / CUBE_PARTICLES) ** (1.0 / 3.0)
        geom = amt.CubeGeometry(lx=side, ly=side, lz=side)
    return amt.CubeConfig(geometry=geom, engine=amt.EngineConfig(
        broadphase="allpairs", **engine))


def allpairs_keys(pos, r: float) -> tuple:
    """K11's z-slab of every particle (allpairs.cu's key, in float64 on
    the card) and the slab width: floor(z / w) mod S, w = 1.001 sqrt(r2)
    with r2 the float32 r^2 the kernel gets."""
    slabs = collide.allpairs_slabs(pos.shape[0])
    width = cells.cell_side(r)
    q = torch.floor(pos[:, 2].double() * (1.0 / width))
    q = torch.where(torch.isfinite(q), q, torch.zeros_like(q))
    return torch.remainder(q, slabs).long(), width


def allpairs_window_tests(pos, r: float) -> int:
    """The pair tests of K11's z-window on this data: sum over the slabs
    of n_s (n_{s-1} + n_s + n_{s+1})."""
    key, _ = allpairs_keys(pos, r)
    counts = torch.bincount(key, minlength=collide.allpairs_slabs(
        pos.shape[0])).double()
    return int((counts * (counts.roll(1) + counts + counts.roll(-1))).sum())


def allpairs_cell_tests(pos, r: float) -> int:
    """The pair tests the function needs on this data: those of a cell
    grid of side w (every hit lies in one of a particle's 27 neighbouring
    cells), sum over the cells of n_c times the particles of its 27."""
    return cells.grid_tests(pos, cells.cell_side(r))


def window_edge_probes(r: float, slabs: int) -> torch.Tensor:
    """Pairs of particles, one x and y a pair, whose z gap is r and one
    float32 ulp either side of it, the lower one on a slab boundary of
    K11's key or one ulp below it: inside the box, at z = 0 and at the
    boundary where the key wraps around (S w)."""
    f32 = np.float32
    width = math.sqrt(float(f32(r * r))) * 1.001
    rows = []
    for k in (1, 7, 150, 294, 0, -3, slabs):
        zb = f32(k * width)
        for zi in (np.nextafter(zb, f32(-np.inf)), zb):
            at_r = f32(zi + f32(r))
            for zj in (np.nextafter(at_r, f32(-np.inf)), at_r,
                       np.nextafter(at_r, f32(np.inf))):
                x = f32(2e-9 * (len(rows) // 2 + 1))
                rows += [(x, f32(50e-9), zi), (x, f32(50e-9), zj)]
    return torch.tensor(np.array(rows, f32), device="cuda")


def check_allpairs(tag: str, sizes=(None, 200_000), reps: int = 20) -> dict:
    """K11 against its plain version, exactly, on the cube's state after
    one drift: at the published 24,627 particles and at a larger box of
    the same density (more slabs, several scan tiles); then with every
    particle in one slab (the quadratic case), with probe pairs at the
    window's edges in front of the gas, and as one call recorded in a
    CUDA graph and replayed three times on moved positions."""
    out = None
    for particles in sizes:
        cfg = cube_config(particles)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(cfg.seed)
        state = init_ops.init_cube(cfg, gen)
        pos = state.pos + cfg.dt * state.vel
        n = pos.shape[0]
        r = cfg.physics.collision_range + cfg.engine.skin
        tile = cfg.engine.allpairs_tile
        got = collide.allpairs_partner_search(pos, r, tile)
        want = collide.allpairs_partner_search_plain(pos, r, tile)
        exact(f"K11 partner (N={n})", got, want)
        hits = int((got >= 0).sum())
        require(hits > 0, f"K11: no particle with a partner at N={n}")
        window = allpairs_window_tests(pos, r)
        print(f"K11 allpairs_partner N={n}: exact; {hits} particles with a "
              f"partner; {window} window pair tests in "
              f"{collide.allpairs_slabs(n)} slabs {tag}")
        if out is not None:
            continue
        check_allpairs_edges(pos, state.vel * cfg.dt, r, tile, tag)
        # The bound is the function's: pos read, partner written, and the
        # pair tests a cell grid needs.  Each algorithm's own work is
        # printed beside it: the window's tests and its slab-ordered copy
        # (16 bytes a particle written and read), the brute force's tests
        # up to the first hit.
        cells = allpairs_cell_tests(pos, r)
        brute = int(torch.where(got >= 0, got.long() + 1, n).sum())
        out = {"allpairs_partner": result(
            0.0,
            maybe_timed(lambda: collide.allpairs_partner_search(
                pos, r, tile), reps),
            maybe_timed(lambda: collide.allpairs_partner_search_plain(
                pos, r, tile), min(reps, 3)),
            tensor_bytes(pos, got), PAIR_TEST_OPS * cells)}
        own_work = result(0.0, None, None, tensor_bytes(pos, got) + 32 * n,
                          PAIR_TEST_OPS * window)
        old = result(0.0, None, None, tensor_bytes(pos, got),
                     PAIR_TEST_OPS * brute)
        k11 = out["allpairs_partner"]
        print(f"K11 allpairs_partner: bound {k11['bound_ms']!r} ms "
              f"({k11['bound_by']}: {tensor_bytes(pos, got)} bytes, {cells} "
              f"cell-grid pair tests); the window's own work, {window} "
              f"pair tests and the copy, {own_work['bound_ms']!r} ms "
              f"({own_work['bound_by']}); the brute force's, {brute} pair "
              f"tests, {old['bound_ms']!r} ms ({old['bound_by']}); the "
              f"brute-force first version: 0.478-0.484 ms {tag}")
        if reps > 0:
            print_times(out, n, tag)
    return out


def check_allpairs_edges(pos, step, r: float, tile: int, tag: str) -> None:
    """K11's hard cases on the cube's gas (see ``check_allpairs``)."""
    n = pos.shape[0]
    _, width = allpairs_keys(pos, r)
    band = pos.clone()
    band[:, 2] = (150.25 + 0.5 * pos[:, 2] / float(pos[:, 2].max())) * width
    key, _ = allpairs_keys(band, r)
    require(int(torch.bincount(key).max()) == n,
            "K11: the band is not one slab")
    got = collide.allpairs_partner_search(band, r, tile)
    exact("K11 partner (one slab)", got,
          collide.allpairs_partner_search_plain(band, r, tile))
    print(f"K11 allpairs_partner, all {n} particles in one slab: exact; "
          f"{int((got >= 0).sum())} particles with a partner {tag}")

    probes = window_edge_probes(r, collide.allpairs_slabs(n + 84))
    m = probes.shape[0]
    require(m == 84, f"K11: {m} probe particles")
    both = torch.cat([probes, pos])
    got = collide.allpairs_partner_search(both, r, tile)
    exact("K11 partner (window edges)", got,
          collide.allpairs_partner_search_plain(both, r, tile))
    # Of each triple of probe pairs the one below r hits its mate (the
    # lowest index near it), the one above does not.
    mate = torch.arange(m, device="cuda") ^ 1
    hit = (got[:m] == mate).view(-1, 3, 2).all(dim=2)
    require(bool(hit[:, 0].all()) and not bool(hit[:, 2].any()),
            "K11: a probe pair at the window's edge is wrong")
    print(f"K11 allpairs_partner, {m // 2} probe pairs at slab boundaries "
          f"with z gaps of r and one ulp either side, wrapped slabs too: "
          f"exact {tag}")

    static = pos.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        collide.allpairs_partner_search(static, r, tile)
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = kernels.launch_counts["allpairs_partner"]
    with torch.cuda.graph(graph, stream=side):
        partner = collide.allpairs_partner_search(static, r, tile)
    require(kernels.launch_counts["allpairs_partner"] == before + 1,
            "K11: the capture recorded other than one call")
    for k in (1, 2, 3):
        static.copy_(pos + k * step)
        graph.replay()
        torch.cuda.synchronize()
        exact("K11 partner (graph replay)", partner,
              collide.allpairs_partner_search_plain(static, r, tile))
    print(f"K11 allpairs_partner: one captured call replayed 3 times on "
          f"moved positions: exact each time {tag}")

    # Look-back words fewer than the scan needs: refused, nothing written.
    slabs = collide.allpairs_slabs(n)
    i32 = dict(dtype=torch.int32, device="cuda")
    partner = torch.full((n,), -7, **i32)
    short = torch.zeros(1, dtype=torch.int64, device="cuda")
    scratch = [torch.zeros(k, **i32) for k in (slabs, slabs + 1, 4 * n)]
    p = kernels.ptr
    try:
        kernels.launch("allpairs_partner", pos.device, p(pos), n,
                       float(np.float32(r * r)), slabs,
                       *map(p, scratch), p(short), 1, p(partner))
        refused = False
    except RuntimeError:
        refused = True
    torch.cuda.synchronize()
    require(refused and bool((partner == -7).all()),
            "K11: a short look-back scratch was not refused")
    print(f"K11 allpairs_partner: a look-back scratch of 1 word for "
          f"{slabs} slabs refused, nothing written {tag}")


def kinetic(state) -> float:
    return float((state.vel.double() ** 2).sum())


def run_cube_slice(tag: str, k11_ms: float) -> dict:
    """Phase 7: the cube at its published size, seed 127, 500 steps, 100
    an epoch; then the reference's mean-free-path check on its own
    validation configuration."""
    cfg = cube_config(steps_per_epoch=100)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = amt.Simulation(amt.make_workload(cfg), device="cuda")
    state, meas, gen = sim.init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = state.num_particles
    require(n == CUBE_PARTICLES, f"cube: {n} particles")
    e0 = kinetic(state)
    marks = []

    def on_epoch(_metrics):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    kernels.launch_counts.clear()
    state, meas, metrics = sim.run(state=state, measure=meas, generator=gen,
                                   epoch_callback=on_epoch)
    torch.cuda.synchronize()
    counts = dict(kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    steps = cfg.num_timesteps
    g = cfg.geometry
    pos = state.pos
    inside = bool(((pos >= 0).all(0)
                   & (pos <= torch.tensor([g.lx, g.ly, g.lz],
                                          device="cuda")).all(0)).all())
    require(inside, "cube slice: a particle left the box")
    require(int(meas.err_count) == 0, "cube slice: wall-solver errors")
    require(bool(torch.isfinite(pos).all()), "cube slice: non-finite state")
    # Specular walls and elastic collisions conserve kinetic energy; in
    # float32 each collision rounds the exchanged velocities once.
    e_rel = abs(kinetic(state) - e0) / e0
    require(e_rel <= 1e-5, f"cube slice: kinetic energy moved by {e_rel}")
    for name in ("allpairs_partner", "resolve_pairs", "flush_hist"):
        require(counts.get(name, 0) == steps,
                f"cube slice: {name} launched {counts.get(name, 0)} times")
    pairs = int(metrics.collisions.sum())
    # At the reference's dt a particle drifts ~9.4 collision ranges a
    # step, so end-of-step overlap detection resolves the snapshot
    # overlaps, N density (4/3) pi cr^3 / 2 pairs a step (PARITY.md).
    cr = cfg.physics.collision_range
    snapshot = n * (n / g.volume) * (4.0 / 3.0) * math.pi * cr**3 / 2.0
    rate = pairs / steps
    require(abs(rate - snapshot) <= 0.2 * snapshot,
            f"cube slice: {rate} pairs a step against {snapshot}")
    mfp = float(meas.path_sum[0]) / int(meas.path_count)
    steady = (steps - STEPS_PER_EPOCH) / (marks[-1] - marks[0])
    step_ms = 1e3 / steady
    print(f"cube slice: N={n} steps={steps} pairs={pairs} ({rate!r} a step; "
          f"snapshot-overlap expectation {snapshot!r}) path_count="
          f"{int(meas.path_count)} mfp={mfp!r} m ({mfp / cfg.physics.lambda_mfp!r}"
          f" lambda at the reference dt) err=0 in-box kinetic energy "
          f"rel change {e_rel!r} (bound 1e-5) {tag}")
    print(f"cube slice: particle-steps/s={steady * n!r} (epochs 2-"
          f"{len(marks)}), step {step_ms!r} ms, K11 share "
          f"{k11_ms / step_ms!r}, init {init_s!r} s, peak memory "
          f"{peak / 2**30!r} GiB {tag}")
    print(f"cube slice: launches {counts} {tag}")
    check_mfp(tag)
    return counts, mfp


def check_mfp(tag: str) -> None:
    """The reference's own physics check (tests/test_mfp_validation.py):
    sigma x4 in a 40 nm box at ambient density, ~0.2 nm of drift a step,
    20 mean-free times, float32 on the card; the measured mean free path
    within 20% of lambda."""
    physics = amt.GasPhysics(sigma=3.6e-19 * 4.0)
    geom = amt.CubeGeometry(lx=40e-9, ly=40e-9, lz=40e-9)
    steps_per_mft = max(1, int(round(physics.tau / (0.2e-9 / physics.v_mean))))
    cfg = amt.CubeConfig(
        geometry=geom, physics=physics, nmft=20, steps_per_mft=steps_per_mft,
        engine=amt.EngineConfig(broadphase="allpairs", steps_per_epoch=500))
    sim = amt.Simulation(amt.make_workload(cfg), device="cuda")
    t0 = time.perf_counter()
    _, meas, _ = sim.run()
    torch.cuda.synchronize()
    count = int(meas.path_count)
    measured = float(meas.path_sum[0]) / count
    lam = physics.lambda_mfp
    require(count > 3000, f"mfp check: {count} completed paths")
    require(abs(measured - lam) <= 0.2 * lam,
            f"mfp check: {measured} against lambda {lam}")
    print(f"mfp check: N={cfg.num_molecules} steps={cfg.num_timesteps} "
          f"paths={count} mfp={measured!r} m, lambda={lam!r} m, ratio "
          f"{measured / lam!r} (bound 0.8-1.2), "
          f"{time.perf_counter() - t0!r} s {tag}")


# --------------------------------------------------------------------------
# The z-slab engine: K12, the slab arguments of K2, K9 and K10, the sharded
# slice and the specular pore
# --------------------------------------------------------------------------


def sharded_sim(particles=PARTICLES, n_shards=SLABS, devices=None,
                energized=True, **engine):
    """The pore cut in ``n_shards`` z-slabs, all on the one card unless
    ``devices`` says otherwise."""
    if energized:
        cfg = config(particles, **engine)
    else:
        cfg = amt.PoreConfig(engine=amt.EngineConfig(
            broadphase="cells", **engine)).scaled_to(particles)
    return amt.ShardedSimulation(amt.make_workload(cfg), n_shards=n_shards,
                                 devices=devices)


def slab_case(particles: int = PARTICLES):
    """The fuller interior slab of the pore cut in SLABS slabs, state of
    seed 17 after one drift, with two colliding pairs planted across each
    of its faces: its lanes, its band and migrant masks, and its local and
    ghost lanes put together as the engine's step does."""
    sim = sharded_sim(particles)
    plan = sim.plan
    state, _, _ = sim.init(SEED)
    consts = sim.slab_constants()
    dt = sim.cfg.dt
    drifted = [(dataclasses.replace(st, vel=st.vel.clone(), pos=torch.where(
        valid[:, None], st.pos + dt * st.vel, st.pos)), valid, gid)
        for st, valid, gid in state]
    s = max(range(1, SLABS - 1), key=lambda k: int(drifted[k][1].sum()))
    # Two overlapping, approaching pairs across each face of slab s, one
    # particle on either side, so that local lanes find ghost partners.
    cr = sim.cfg.physics.collision_range
    for lower in (s - 1, s):
        z_face = float(plan.slab_z[lower + 1])
        for k in range(2):
            for slab, lane, side in ((lower, k, -1.0), (lower + 1, 2 + k, 1.0)):
                st = drifted[slab][0]
                st.pos[lane] = torch.tensor(
                    [(2 * k - 1) * 5 * cr, 0.0, z_face + side * 0.3 * cr])
                st.vel[lane] = torch.tensor([0.0, 0.0, -side * 300.0])

    def halo(k, up):
        st, valid, gid = drifted[k]
        z = st.pos[:, 2]
        edge = z > consts[k].up_edge if up else z < consts[k].down_edge
        return pack.pack_band({"pos": st.pos, "vel": st.vel, "gid": gid},
                              valid & edge, plan.halo_capacity)

    (gb, gb_flag, _), (ga, ga_flag, _) = halo(s - 1, True), halo(s + 1, False)
    st, valid, gid = drifted[s]
    c = consts[s]
    z = st.pos[:, 2]
    return SimpleNamespace(
        sim=sim, plan=plan, c=c, st=st, valid=valid, gid=gid,
        cap=plan.shard_capacity, cr=cr,
        gen=torch.Generator(device="cuda").manual_seed(SEED),
        band={"pos": st.pos, "vel": st.vel, "gid": gid},
        payload={"pos": st.pos, "vel": st.vel, "paths": st.paths,
                 "hc": st.has_collided, "gid": gid},
        halo_up=valid & (z > c.up_edge), go_up=valid & (z >= c.z_hi),
        pos=torch.cat([st.pos, gb["pos"], ga["pos"]]),
        vel=torch.cat([st.vel, gb["vel"], ga["vel"]]),
        ids=torch.cat([gid, gb["gid"], ga["gid"]]),
        lanes=torch.cat([valid, gb_flag, ga_flag]),
        local=torch.cat([valid, c.ghost_false]),
        window=(c.cell_start, plan.cell_window))


def exact_pack(label: str, got, want) -> None:
    """One (buf, flag, dropped) or (idx, flag, dropped) of K12 bitwise
    equal to its plain version's."""
    got_buf, want_buf = got[0], want[0]
    if isinstance(got_buf, dict):
        require(set(got_buf) == set(want_buf), f"K12 {label}: fields")
        for name in got_buf:
            exact(f"K12 {label} {name}", got_buf[name], want_buf[name])
    else:
        exact(f"K12 {label} idx", got_buf, want_buf)
    exact(f"K12 {label} flag", got[1], want[1])
    exact(f"K12 {label} dropped", got[2], want[2])


def exact_pair(label: str, got, want) -> None:
    """K12's two-direction entry bitwise equal to its plain version."""
    exact_pack(f"{label} up", got[0], want[0])
    exact_pack(f"{label} down", got[1], want[1])
    if len(want) > 2:
        exact(f"K12 {label} the lanes that stay", got[2], want[2])


def pack_cases(case):
    """(label, fields, capacity, up edge, down edge, up_inclusive) of the
    two exchanges of a step: the halo bands and the migrants (an interior
    slab, so both sides have a neighbour)."""
    c, plan = case.c, case.plan
    return (("halo bands", case.band, plan.halo_capacity, c.up_edge,
             c.down_edge, False),
            ("migrants", case.payload, plan.migration_capacity, c.z_hi,
             c.z_lo, True))


def check_pack(case, tag: str, reps: int) -> dict:
    """K12's three entries against their plain versions at the slab's real
    sizes, bitwise (buffers, flags, dropped, index form, the lanes that
    stay).  The mask entries (``pack_band``, ``pack_indices``) on the halo
    band (pos, vel, gid into halo_capacity slots) and the migrants (five
    fields into migration_capacity slots): with room, with a capacity of
    half the count (the highest lanes dropped), with no lane set, and at
    capacity 0.  The two-direction entry (``pack_band_pair``, the step's)
    on both exchanges: with room, truncated, with no lane selected, and
    without a neighbour on either side.  Then each entry recorded in a
    CUDA graph and replayed (``check_pack_graph``).  Timed on the halo
    bands; the library column is the masks, ``torch.nonzero`` and one
    ``index_select`` a field, for both directions."""
    nothing = torch.zeros_like(case.valid)
    for label, fields, mask in (("halo band", case.band, case.halo_up),
                                ("migrants", case.payload, case.go_up)):
        capacity = (case.plan.halo_capacity if label == "halo band"
                    else case.plan.migration_capacity)
        count = int(mask.sum())
        require(0 < count <= capacity,
                f"K12 {label}: {count} lanes for {capacity} slots")
        for variant, cap, m in (("with room", capacity, mask),
                                ("truncated", max(count // 2, 1), mask),
                                ("no lane set", capacity, nothing),
                                ("capacity 0", 0, mask)):
            got = pack.pack_band(fields, m, cap)
            exact_pack(f"{label} {variant}", got,
                       pack.pack_band_plain(fields, m, cap))
            exact_pack(f"{label} {variant} index form",
                       pack.pack_indices(m, cap),
                       pack.pack_indices_plain(m, cap))
            require(int(got[2]) == max(int(m.sum()) - cap, 0),
                    f"K12 {label} {variant}: dropped {int(got[2])}")
            print(f"K12 pack_band {label} {variant}: {int(m.sum())} of "
                  f"{m.shape[0]} lanes into {cap} slots, {len(fields)} "
                  f"fields: buffers bitwise, flag, dropped={int(got[2])} and "
                  f"the index form exact {tag}")
    for label, fields, cap, up, down, inclusive in pack_cases(case):
        both = pack.pack_band_pair_plain(fields, case.valid, cap, up, down,
                                         inclusive)
        counts = [int(side[1].sum()) + int(side[2]) for side in both]
        require(max(counts) > 0, f"K12 pair {label}: counts {counts}")
        for variant, k, valid, u, d in (
                ("with room", cap, case.valid, up, down),
                ("truncated", max(max(counts) // 2, 1), case.valid, up,
                 down),
                ("no lane selected", cap, nothing, up, down),
                ("no neighbour above", cap, case.valid, None, down),
                ("no neighbour below", cap, case.valid, up, None)):
            args = (fields, valid, k, u, d, inclusive)
            got = pack.pack_band_pair(*args, rest=True)
            exact_pair(f"pair {label} {variant}", got,
                       pack.pack_band_pair_plain(*args, rest=True))
            print(f"K12 pack_band_pair {label} {variant}: up "
                  f"{int(got[0][1].sum())} (dropped {int(got[0][2])}), down "
                  f"{int(got[1][1].sum())} (dropped {int(got[1][2])}) of "
                  f"{int(valid.sum())} valid lanes into 2 x {k} slots, "
                  f"{len(fields)} fields, one launch: buffers, flags, "
                  f"dropped and the lanes that stay bitwise {tag}")
    check_pack_graph(case, tag)

    c = case.c
    fields, valid, cap = case.band, case.valid, case.plan.halo_capacity
    pos = fields["pos"]
    n = valid.shape[0]
    row_bytes = sum(a[0].numel() * a.element_size() for a in fields.values())

    def library():
        z = pos[:, 2]
        out = []
        for m in (valid & (z > c.up_edge), valid & (z < c.down_edge)):
            idx = torch.nonzero(m).flatten()[:cap]
            out.append([torch.index_select(a, 0, idx)
                        for a in fields.values()])
        return out

    up, down = pack.pack_band_pair_plain(fields, valid, cap, c.up_edge,
                                         c.down_edge)
    kept = int(up[1].sum()) + int(down[1].sum())
    # valid once, z of the valid lanes, the kept rows read, every slot and
    # flag of both sides written, dropped.
    io = (n + 4 * int(valid.sum()) + kept * row_bytes
          + 2 * cap * (row_bytes + 1) + 8)
    pair_args = (fields, valid, cap, c.up_edge, c.down_edge)
    out = {"pack_band_pair": result(
        0.0, maybe_timed(lambda: pack.pack_band_pair(*pair_args), reps),
        maybe_timed(lambda: pack.pack_band_pair_plain(*pair_args), reps),
        io, 0.0, maybe_timed(library, reps))}
    # The index form as the sharded pairs mode freezes its export lists:
    # the mask read, every slot's index and flag written, dropped.
    mask = case.halo_up
    out["pack_indices"] = result(
        0.0, maybe_timed(lambda: pack.pack_indices(mask, cap), reps),
        maybe_timed(lambda: pack.pack_indices_plain(mask, cap), reps),
        n + 5 * cap + 4, 0.0,
        maybe_timed(lambda: torch.nonzero(mask).flatten()[:cap], reps))
    if reps > 0:
        print_times(out, n, f"(both halo bands, one call; the index form "
                    f"on the up band) {tag}")
        one = {"pack_band": result(
            0.0, timed_ms(lambda: pack.pack_band(fields, mask, cap), reps),
            timed_ms(lambda: pack.pack_band_plain(fields, mask, cap), reps),
            n + int(mask.sum()) * row_bytes + cap * (row_bytes + 1) + 4, 0.0,
            timed_ms(lambda: [torch.index_select(a, 0, torch.nonzero(
                mask).flatten()[:cap]) for a in fields.values()], reps))}
        print_times(one, n, f"(the up band from its mask) {tag}")
    return out


def check_pack_graph(case, tag: str) -> None:
    """K12's three entries recorded in one CUDA graph and replayed three
    times on the slab's positions moved by one, two and three more drifts
    (the masks follow the positions): every replay bitwise equal to the
    plain versions.  One call of each on the capturing stream first, as
    for K6."""
    dt = case.sim.cfg.dt
    c = case.c
    st = case.st
    static = {"pos": st.pos.clone(), "vel": st.vel.clone(),
              "gid": case.gid.clone()}
    valid = case.valid.clone()
    mask = torch.zeros_like(valid)
    cap = case.plan.halo_capacity

    def calls():
        return (pack.pack_band(static, mask, cap),
                pack.pack_indices(mask, cap),
                pack.pack_band_pair(static, valid, cap, c.up_edge,
                                    c.down_edge, rest=True))

    side = torch.cuda.Stream(valid.device)
    side.wait_stream(torch.cuda.current_stream(valid.device))
    with torch.cuda.stream(side):
        calls()
    side.synchronize()
    scratches = len(compact._scratch)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = calls()
    require(len(compact._scratch) == scratches,
            "K12: the capture allocated a scratch")
    counts = []
    for k in (1, 2, 3):
        static["pos"].copy_(torch.where(valid[:, None],
                                        st.pos + (k * dt) * st.vel, st.pos))
        mask.copy_(valid & (static["pos"][:, 2] > c.up_edge))
        graph.replay()
        torch.cuda.synchronize()
        exact_pack(f"pack_band (graph replay {k})", out[0],
                   pack.pack_band_plain(static, mask, cap))
        exact_pack(f"pack_indices (graph replay {k})", out[1],
                   pack.pack_indices_plain(mask, cap))
        exact_pair(f"pack_band_pair (graph replay {k})", out[2],
                   pack.pack_band_pair_plain(static, valid, cap, c.up_edge,
                                             c.down_edge, rest=True))
        counts.append((int(out[2][0][1].sum()), int(out[2][1][1].sum())))
    print(f"K12 pack_band, pack_indices and pack_band_pair: one capture "
          f"replayed 3 times on positions moved by 1-3 more drifts (halo "
          f"lanes up, down: {counts}): bitwise each time {tag}")


def check_slab_kernels(case, tag: str, reps: int) -> None:
    """K2, K9 and K10 with their z-slab arguments against their plain
    versions on one slab's local and ghost lanes (exact, exact, state
    within 2 ulp); and with arguments that change nothing (every lane
    valid, ids = lane index, the whole grid as window, every lane local)
    against the calls without them."""
    grid, r, cap = case.c.grid, case.cr, case.cap
    pos, ids, lanes, local = case.pos, case.ids, case.lanes, case.local
    n = pos.shape[0]
    got = collide.bin_and_table(pos, grid, valid=lanes)
    want = collide.bin_and_table_plain(pos, grid, valid=lanes)
    for name, a, b in zip(("cell_id", "table", "pslot", "overflow"), got,
                          want):
        exact(f"K2 {name} (valid)", a, b)
    _, table, pslot, overflow = got
    print(f"K2 bin_and_table valid=: exact on {n} lanes "
          f"({int(lanes.sum())} valid, {int(lanes[cap:].sum())} ghosts); "
          f"overflow={int(overflow)} {tag}")

    kw = dict(ids=ids, valid=lanes, cell_window=case.window)
    partner = collide.partner_sweep(pos, table, pslot, grid, r, **kw)
    exact("K9 partner (ids, valid, cell_window)", partner,
          collide.partner_sweep_plain(pos, table, pslot, grid, r, **kw))
    has = partner >= 0
    require(int((has[:cap] & (partner[:cap] >= cap)).sum()) >= 4,
            "K9 (slab): the pairs planted across the faces found no ghost "
            "partner")
    print(f"K9 partner_sweep ids=, valid=, cell_window={case.window}: "
          f"exact; {int(has.sum())} lanes with a partner, "
          f"{int((has[:cap] & (partner[:cap] >= cap)).sum())} local lanes "
          f"whose partner is a ghost {tag}")
    # Candidates ordered by global id; at three collision ranges too, where
    # most lanes have several.
    wide = collide.partner_sweep(pos, table, pslot, grid, 3.0 * r, **kw)
    exact("K9 partner (ids, valid, cell_window, radius 3 cr)", wide,
          collide.partner_sweep_plain(pos, table, pslot, grid, 3.0 * r, **kw))
    print(f"K9 partner_sweep ids=, radius 3 cr: exact; "
          f"{int((wide >= 0).sum())} lanes with a partner {tag}")

    u = torch.rand((n, 6), generator=case.gen, device="cuda")
    ghost = ~local
    paths = torch.where(ghost[:, None], 0.0, u[:, :4] * 2e-7)
    comb = ParticleState(pos=pos, vel=case.vel, paths=paths,
                         has_collided=(u[:, 4] < 0.6) & local)
    meas = dataclasses.replace(
        Measurements.zeros(case.sim.cfg.engine.num_bins, torch.float32, n,
                           "cuda"),
        pending_vals=u[:, :4].flip(1) * 1e-6, pending_mask=u[:, 5] < 0.1)
    _, _, gc, ulps, k10_err, gok = check_k10_case(
        "local_mask", comb, meas, partner, r, local)
    print(f"K10 resolve_pairs local_mask=: {int(gok.sum())} lanes matched, "
          f"{int(gc) - 7} applied (local); count, ok mask and staging exact, "
          f"state {ulps} ulp from plain (bound 2), in place, ghost lanes "
          f"and every lane not applied to untouched {tag}")

    # Arguments that change nothing, on the valid lanes alone.
    live = pos[lanes].contiguous()
    m = live.shape[0]
    everyone = torch.ones(m, dtype=torch.bool, device="cuda")
    plain_k2 = collide.bin_and_table(live, grid)
    for name, a, b in zip(("cell_id", "table", "pslot", "overflow"),
                          collide.bin_and_table(live, grid, valid=everyone),
                          plain_k2):
        exact(f"K2 {name} (every lane valid) against no argument", a, b)
    _, t2, p2, _ = plain_k2
    plain_k9 = collide.partner_sweep(live, t2, p2, grid, r)
    exact("K9 (neutral arguments) against no argument",
          collide.partner_sweep(
              live, t2, p2, grid, r, valid=everyone,
              ids=torch.arange(m, dtype=torch.int32, device="cuda"),
              cell_window=(0, grid.num_cells)), plain_k9)
    small = ParticleState(pos=live, vel=case.vel[lanes].contiguous(),
                          paths=paths[lanes].contiguous(),
                          has_collided=comb.has_collided[lanes].contiguous())
    smeas = dataclasses.replace(
        meas, pending_vals=meas.pending_vals[lanes].contiguous(),
        pending_mask=meas.pending_mask[lanes].contiguous())
    zero = torch.zeros((), dtype=torch.int32, device="cuda")
    a_s, a_m, a_c = collide.resolve_pairs(own(small), own(smeas), plain_k9,
                                          r, count=zero.clone())
    b_s, b_m, b_c, b_ok = collide.resolve_pairs(
        own(small), own(smeas), plain_k9, r, count=zero.clone(),
        local_mask=everyone)
    for f in ("pos", "vel", "paths", "has_collided"):
        exact(f"K10 {f} (every lane local) against no argument",
              getattr(b_s, f), getattr(a_s, f))
    exact("K10 pending_vals (every lane local) against no argument",
          b_m.pending_vals, a_m.pending_vals)
    require(int(b_c) == 2 * int(a_c) == int(b_ok.sum()),
            f"K10: {int(b_c)} applied against {int(a_c)} pairs")
    print(f"K2, K9, K10 with arguments that change nothing: equal to the "
          f"calls without them on {m} lanes ({int(a_c)} pairs) {tag}")
    if reps > 0:
        for name, fn, plain in (
                ("bin_and_table",
                 lambda: collide.bin_and_table(pos, grid, valid=lanes),
                 lambda: collide.bin_and_table_plain(pos, grid, valid=lanes)),
                ("partner_sweep",
                 lambda: collide.partner_sweep(pos, table, pslot, grid, r,
                                               **kw),
                 lambda: collide.partner_sweep_plain(pos, table, pslot, grid,
                                                     r, **kw))):
            print(f"time {name} with its z-slab arguments: kernel "
                  f"{timed_ms(fn, reps)!r} ms, plain "
                  f"{timed_ms(plain, min(reps, 3))!r} ms on {n} lanes of one "
                  f"of {SLABS} slabs {tag}")
        time_resolve_pairs(comb, meas, partner, r, k10_err, reps, tag,
                           local=local, label=f"with its z-slab arguments on "
                           f"{n} lanes of one of {SLABS} slabs")


def check_slab(tag: str, particles: int = PARTICLES, reps: int = 20) -> dict:
    """Phase 2, z-slab side: K12, and K2, K9, K10 with their arguments."""
    case = slab_case(particles)
    out = check_pack(case, tag, reps)
    check_slab_kernels(case, tag, reps)
    return out


def to_card(obj):
    """A dataclass of tensors, a tensor, or a list or tuple of them, on
    the card."""
    if isinstance(obj, torch.Tensor):
        return obj.cuda()
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_card(x) for x in obj)
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).cuda()
        for f in dataclasses.fields(obj)})


def slab_of_gid(state, n: int) -> torch.Tensor:
    """(n,) the slab that holds each global id; fails unless the live
    lanes hold every id 0..n-1 exactly once."""
    where = torch.full((n,), -1, dtype=torch.int64, device="cuda")
    live = 0
    for s, (_, valid, gid) in enumerate(state):
        ids = gid[valid].long().to("cuda")
        live += ids.numel()
        where[ids] = s
    require(live == n and int((where >= 0).sum()) == n,
            f"sharded: {live} live lanes, {int((where >= 0).sum())} distinct "
            f"ids, expected {n}")
    return where


def check_sharded_against_cpu(tag: str, particles: int = 20_000,
                              steps: int = 10) -> None:
    """The 4-slab sharded sweep on the card against the same on the CPU
    (which tests/test_torch_sharding.py holds to the JAX package), from
    one split state and one set of uniforms: valid, gid, counts and the
    histogram equal, the state within the cos/sin rounding of the two
    devices."""
    cpu = sharded_sim(particles, devices=["cpu"], steps_per_epoch=5)
    gpu = sharded_sim(particles, steps_per_epoch=5)
    state, meas, _ = cpu.init(SEED)
    n = cpu.cfg.num_molecules
    cap = cpu.plan.shard_capacity
    gen = torch.Generator().manual_seed(SEED)
    uniforms = torch.rand((steps, SLABS, cap, 2), generator=gen)
    s_c, m_c, met_c = cpu.run(steps, state=state, measure=meas,
                              draw=lambda s, i: uniforms[i, s])
    s_g, m_g, met_g = gpu.run(steps, state=to_card(state),
                              measure=to_card(meas),
                              draw=lambda s, i: uniforms[i, s].cuda())
    for f in ("collisions", "wall_hits", "oob_after_walls",
              "oob_after_pairs"):
        exact(f"sharded small run {f}", getattr(met_g, f).cpu(),
              getattr(met_c, f))
    t_c, t_g = cpu.finalize_measure(m_c), gpu.finalize_measure(m_g)
    for f in ("hist", "path_count", "collision_count", "err_count",
              "overflow_count", "halo_trunc_count", "hist_drop_count"):
        exact(f"sharded small run {f}", getattr(t_g, f).cpu(),
              getattr(t_c, f))
    rel = 0.0
    for k, ((st_g, v_g, g_g), (st_c, v_c, g_c)) in enumerate(zip(s_g, s_c)):
        exact(f"sharded small run valid (slab {k})", v_g.cpu(), v_c)
        exact(f"sharded small run gid (slab {k})", g_g.cpu()[v_c], g_c[v_c])
        exact(f"sharded small run has_collided (slab {k})",
              st_g.has_collided.cpu()[v_c], st_c.has_collided[v_c])
        for f in ("pos", "vel", "paths"):
            a, b = getattr(st_g, f).cpu()[v_c], getattr(st_c, f)[v_c]
            rel = max(rel, float((a - b).abs().max() / b.abs().max()))
    require(rel <= 1e-5, f"sharded small run: state differs by {rel} "
            f"relative")
    moved = int((slab_of_gid(s_g, n) != slab_of_gid(to_card(state), n)).sum())
    pairs = int((met_c.collisions - met_c.wall_hits).sum())
    require(moved > 0 and pairs > 0,
            f"sharded small run: {moved} migrants, {pairs} pair collisions")
    print(f"sharded small run vs CPU: N={n} slabs={SLABS} steps={steps} "
          f"pairs={pairs} wall_hits={int(met_c.wall_hits.sum())} "
          f"migrated={moved}: valid, gid, counts and histogram equal, state "
          f"max rel err {rel!r} (bound 1e-5) {tag}")


def run_sharded_slice(tag: str, sweep_pairs: int) -> dict:
    """Phase 8: the sharded sweep at full width, counted.  ``sweep_pairs``
    is the single-slab sweep's pair-collision total over the same steps
    from the same initial state (phase 5)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = sharded_sim(steps_per_epoch=STEPS_PER_EPOCH)
    state, meas, gens = sim.init(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sim.cfg.num_molecules
    plan = sim.plan
    epochs, per_epoch = [], []
    kernels.launch_counts.clear()
    for e in range(STEPS // STEPS_PER_EPOCH):
        t0 = time.perf_counter()
        state, meas, met = sim.run(
            STEPS_PER_EPOCH, state=state, measure=meas, generators=gens,
            start_step=e * STEPS_PER_EPOCH)
        torch.cuda.synchronize()
        per_epoch.append(time.perf_counter() - t0)
        counts = dict(kernels.launch_counts)
        epochs.append(met)
        slab_of_gid(state, n)  # every id 0..N-1 live exactly once
    peak = torch.cuda.max_memory_allocated()
    metrics = StepMetrics.concat(epochs)
    tot = sim.finalize_measure(meas)
    for f in ("overflow_count", "halo_trunc_count", "err_count"):
        require(int(getattr(tot, f)) == 0,
                f"sharded slice: {f}={int(getattr(tot, f))}")
    live = ParticleState(**{
        f.name: torch.cat([getattr(st, f.name)[valid]
                           for st, valid, _ in state])
        for f in dataclasses.fields(ParticleState)})
    require(all(bool(torch.isfinite(t).all())
                for t in (live.pos, live.vel, live.paths)),
            "sharded slice: non-finite state")
    require(int(oob.pore_oob_count(live, sim.cfg.geometry)) == 0,
            "sharded slice: particles out of bounds")
    pairs = int((metrics.collisions - metrics.wall_hits).sum())
    hits = int(metrics.wall_hits.sum())
    require(abs(pairs - sweep_pairs) <= 0.01 * sweep_pairs,
            f"sharded slice: {pairs} pair collisions against the single "
            f"slab's {sweep_pairs}")
    require(int(tot.collision_count) == pairs + hits,
            "sharded slice: collision_count is not pairs + wall hits")
    drop = int(tot.hist_drop_count)
    require(drop == 0 and bool(
        (tot.hist.sum(dim=1) == int(tot.path_count)).all()),
        "sharded slice: histogram rows do not sum to path_count")
    expected = {"pack_band_pair": 2, "pack_band": 0, "pore_advance": 1,
                "bin_and_table": 1, "partner_sweep": 1, "resolve_pairs": 1,
                "flush_hist": 1, "compact": 1}
    for name, per_step in expected.items():
        require(counts.get(name, 0) == per_step * SLABS * STEPS,
                f"sharded slice: {name} launched {counts.get(name, 0)} "
                f"times, expected {per_step} a slab a step")

    # Traffic across every interior face: the lanes in each halo band now,
    # and the particles that PROBE more steps move to another slab (the
    # narrow pore's face sees one or two a step).
    consts = sim.slab_constants()
    halo = []
    for s, ((st, valid, _), c) in enumerate(zip(state, consts)):
        z = st.pos[:, 2]
        if s < SLABS - 1:
            halo.append(int((valid & (z > c.up_edge)).sum()))
        if s > 0:
            halo.append(int((valid & (z < c.down_edge)).sum()))
    before = slab_of_gid(state, n)
    probe = 20
    after = slab_of_gid(sim.run(probe, state=state, measure=meas,
                                generators=gens, start_step=STEPS)[0], n)
    up = [int(((before == s) & (after == s + 1)).sum())
          for s in range(SLABS - 1)]
    down = [int(((before == s + 1) & (after == s)).sum())
            for s in range(SLABS - 1)]
    require(min(halo) > 0 and min(up) > 0 and min(down) > 0,
            f"sharded slice: a face without traffic (halo {halo}, up {up}, "
            f"down {down})")
    steady = (STEPS - STEPS_PER_EPOCH) / sum(per_epoch[1:])
    print(f"sharded slice: N={n} slabs={SLABS} on "
          f"{len(set(sim.devices))} card(s) steps={STEPS} pairs={pairs} "
          f"(single slab {sweep_pairs}) wall_hits={hits} "
          f"path_count={int(tot.path_count)} overflow=0 halo_trunc=0 err=0 "
          f"oob=0 finite=True; ids 0..N-1 live after every epoch; lanes "
          f"{[int(v.sum()) for _, v, _ in state]} of {plan.shard_capacity} "
          f"{tag}")
    print(f"sharded slice: halo lanes by face and direction {halo} of "
          f"{plan.halo_capacity} slots, particles moved a slab up {up} and "
          f"down {down} by {probe} more steps ({plan.migration_capacity} "
          f"slots a step) {tag}")
    print(f"sharded slice: particle-steps/s={steady * n!r} (epochs 2-"
          f"{len(per_epoch)}), step {1e3 / steady!r} ms, first epoch "
          f"{per_epoch[0]!r} s, init {init_s!r} s, peak memory "
          f"{peak / 2**30!r} GiB {tag}")
    print(f"sharded slice: launches {counts} {tag}")
    return counts, pairs


# --------------------------------------------------------------------------
# The sharded pairs mode and the sharded cube
# --------------------------------------------------------------------------


def snapshot(x):
    """``x`` with every tensor cloned: tensors, dataclasses of tensors
    (fields that are None stay), tuples and lists of them; anything else
    as it is."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return type(x)(snapshot(y) for y in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: snapshot(getattr(x, f.name))
            for f in dataclasses.fields(x)
            if isinstance(getattr(x, f.name), torch.Tensor)})
    return x


def capture_slab_calls(sim, state, meas, gens, steps: int = 2) -> dict:
    """Run the sharded pairs engine ``steps`` steps from ``state``,
    recording a snapshot of the arguments of every call to K1-K5's
    entries (``pairs_ops.rebuild``, ``test_and_resolve``,
    ``research_dirty``) as (args, kwargs), slab after slab in call
    order."""
    names = ("rebuild", "test_and_resolve", "research_dirty")
    calls = {name: [] for name in names}
    saved = {name: getattr(pairs_ops, name) for name in names}

    def wrap(name):
        def call(*args, **kw):
            calls[name].append((snapshot(args), snapshot(kw)))
            return saved[name](*args, **kw)
        return call

    try:
        for name in names:
            setattr(pairs_ops, name, wrap(name))
        sim.run(steps, state=state, measure=meas, generators=gens)
        torch.cuda.synchronize()
    finally:
        for name, fn in saved.items():
            setattr(pairs_ops, name, fn)
    return calls


def emitting(pslot, grid, valid, active_window) -> torch.Tensor:
    """The particles K1 lets emit (a slot in a cell of the slab's window);
    the plain version's rule (ops/collide._emitters)."""
    cap = grid.capacity
    listed = (pslot < grid.num_cells * cap) & valid
    cell = torch.where(listed, pslot // cap, grid.num_cells).long()
    return collide._emitters(cell, listed, grid, None, active_window)[0]


def check_sharded_pairs_kernels(tag: str, particles: int = PARTICLES,
                                reps: int = 20) -> dict:
    """K1, K5, K3 and K4 with their z-slab arguments against their plain
    versions on the card, on the arguments the sharded pairs engine hands
    them for the fullest interior one of 4 slabs of the 1M pore: K2, K1
    and K5 at its first rebuild (its local and ghost lanes, their global
    ids and valid lanes, its cell window and active slice), K3 and K4 at
    its second step.  Integers exact, floats within 2 ulp; timed beside
    their bounds from these inputs.  Returns each kernel's slab-form
    result."""
    sim = sharded_sim(particles, **PAIRS)
    state, meas, gens = sim.init(SEED)
    s = max(range(1, SLABS - 1), key=lambda k: int(state[k][1].sum()))
    calls = capture_slab_calls(sim, state, meas, gens)
    require(all(len(v) == 2 * SLABS or (k == "rebuild" and len(v) == SLABS)
                for k, v in calls.items()),
            f"sharded pairs calls: { {k: len(v) for k, v in calls.items()} }")
    out = {}

    # K2 + K1 + K5 at the rebuild.
    (comb, grid, pcfg, cr, dt, _), kw = calls["rebuild"][s]
    ids, valid = kw["ids"], kw["valid_lanes"]
    n, cap = valid.shape[0], sim.plan.shard_capacity
    reach, clipped = pairs_ops.reach_radii(
        comb.vel, cr, dt, pcfg.rebuild_interval, 0.5 * grid.cell_size)
    got = collide.bin_and_table(comb.pos, grid, valid=valid)
    for name, a, b in zip(("cell_id", "table", "pslot", "overflow"), got,
                          collide.bin_and_table_plain(comb.pos, grid,
                                                      valid=valid)):
        exact(f"K2 {name} (sharded pairs rebuild)", a, b)
    _, table, pslot, overflow = got
    k1 = (comb.pos, reach, table, pslot, grid, pcfg.top_k)
    k1_kw = dict(ids=ids, valid=valid, cell_window=kw["cell_window"],
                 active_window=kw["active_window"])
    got = collide.rebuild_sweep(*k1, **k1_kw)
    want = collide.rebuild_sweep_plain(*k1, **k1_kw)
    for name, a, b in zip(("cands", "unswept", "pos0", "reach0"), got,
                          want):
        exact(f"K1 {name} (slab)", a, b)
    cands, unswept = got[0], got[1]
    to_ghost = int(((cands[:cap] >= cap)).sum())
    emit = emitting(pslot, grid, valid, kw["active_window"])
    require(int((cands >= 0).sum()) > 0 and to_ghost > 0,
            f"K1 (slab): {int((cands >= 0).sum())} candidates, {to_ghost} "
            f"from a local lane to a ghost")
    print(f"K1 rebuild_sweep ids=, valid=, active_window="
          f"{kw['active_window']}: exact on {n} lanes ({int(valid.sum())} "
          f"valid, {int(valid[cap:].sum())} ghosts), {int(emit.sum())} "
          f"emitting, {int((cands >= 0).sum())} candidates ({to_ghost} local "
          f"-> ghost), {int((cands[:, -1] >= 0).sum())} full rows, "
          f"{int(unswept.sum())} unswept {tag}")
    tests = neighbor_slots(table, torch.where(
        emit, pslot, grid.num_cells * grid.capacity), grid, n, slice(13, 27))
    out["rebuild_sweep"] = result(
        0.0, maybe_timed(lambda: collide.rebuild_sweep(*k1, **k1_kw), reps),
        maybe_timed(lambda: collide.rebuild_sweep_plain(*k1, **k1_kw),
                    min(reps, 3)),
        tensor_bytes(k1[:4], grid.neighbors, grid.active_rank, ids, valid,
                     got), PAIR_TEST_OPS * tests)
    zero = torch.zeros((), dtype=torch.int32, device=cands.device)
    k5 = (cands, pslot, clipped, unswept, overflow, zero, zero,
          grid.num_cells * grid.capacity, pcfg.pair_capacity, valid)
    got5 = pairs_ops.emit_pairs(*k5)
    for name, a, b in zip(("a", "b", "cursor", "hot", "pending1", "overflow",
                           "spill"), got5, pairs_ops.emit_pairs_plain(*k5)):
        exact(f"K5 {name} (valid_lanes)", a, b)
    require(not bool(got5[3][~valid].any()) and int(got5[2]) > 0,
            "K5 (valid_lanes): an invalid lane hot, or no entry")
    print(f"K5 emit_pairs valid_lanes=: exact; cursor={int(got5[2])} "
          f"hot={int(got5[3].sum())} pending1={int(got5[4].sum())} "
          f"overflow={int(got5[5])} spill={int(got5[6])} {tag}")
    out["emit_pairs"] = result(
        0.0, maybe_timed(lambda: pairs_ops.emit_pairs(*k5), reps),
        maybe_timed(lambda: pairs_ops.emit_pairs_plain(*k5), min(reps, 5)),
        tensor_bytes(k5[:7], valid, got5))

    # K3 at the second step of the window.
    (st, ms, a, b, cr, e_cap), kw3 = calls["test_and_resolve"][SLABS + s]
    (ks, km, kc, kmask), err, ulps = check_k3_case(
        "slab", st, ms, a, b, cr, e_cap, **kw3)
    local = kw3["local_mask"]
    require(int(kc) > 0, "K3 (slab): no pair counted")
    print(f"K3 test_and_resolve ids=, local_mask=: {int(kc)} pairs counted "
          f"here, {int(kmask.sum())} lanes resolved "
          f"({int(kmask[~local].sum())} ghosts); mask, count, staging and "
          f"counters exact, state {ulps} ulp from plain (bound 2), in place "
          f"{tag}")
    t3s, t3m = own(st), own(ms)

    def reset3():
        refill(t3s, st)
        refill(t3m, ms)

    timing = (None, None)
    if reps > 0:
        k3_ms, _, _ = net_ms(lambda: pairs_ops.test_and_resolve(
            t3s, t3m, a, b, cr, e_cap, **kw3), reset3, reps)
        timing = (k3_ms, timed_ms(lambda: pairs_ops.test_and_resolve_plain(
            own(st), own(ms), a, b, cr, e_cap, **kw3), min(reps, 5)))
    # As K3's bound (check_test_and_resolve), on these lanes, with the ids
    # of the events' endpoints and the local mask of the resolved ones.
    listed = (a < n) & (b < n)
    touched = torch.unique(torch.cat([a[listed], b[listed]])).numel()
    d = st.pos[b[listed].long()] - st.pos[a[listed].long()]
    events = min(int(((d * d).sum(1) < cr * cr).sum()), e_cap)
    resolved = int(kmask.sum())
    out["test_and_resolve"] = result(
        err, *timing, 8 * a.shape[0] + 12 * touched + 24 * events
        + 102 * resolved + n,
        PAIR_TEST_OPS * int(listed.sum()) + 35 * resolved)

    # K4 at the second step.
    (comb4, plist, dirty_idx, bump, grid4, pcfg4, cr4, dt4), kw4 = \
        calls["research_dirty"][SLABS + s]

    def own_list(pl):
        return dataclasses.replace(pl, a=pl.a.clone(), b=pl.b.clone(),
                                   hot=pl.hot.clone(),
                                   reach0=pl.reach0.clone())

    args4 = (dirty_idx, bump, grid4, pcfg4, cr4, dt4)
    want4 = pairs_ops.research_dirty_plain(comb4, own_list(plist), *args4,
                                           **kw4)
    got4 = pairs_ops.research_dirty(comb4, own_list(plist), *args4, **kw4)
    for f in K4_FIELDS:
        exact(f"K4 {f} (ids)", getattr(got4[0], f), getattr(want4[0], f))
    exact("K4 lost (ids)", got4[1], want4[1])
    exact("K4 latent_per (ids)", got4[2], want4[2])
    live = int((dirty_idx < n).sum())
    appended = int(got4[0].cursor) - int(plist.cursor)
    require(live > 0, "K4 (ids): no dirty lane")
    print(f"K4 research_dirty ids=: exact in place; {live} dirty of "
          f"{dirty_idx.numel()} lanes ({int(((dirty_idx >= cap) & (dirty_idx < n)).sum())}"
          f" ghosts), appended={appended} lost={bool(got4[1])} {tag}")
    scratch = own_list(plist)
    timing = (None, None)
    if reps > 0:
        k4_ms, _, _ = net_ms(
            lambda: pairs_ops.research_dirty(comb4, scratch, *args4, **kw4),
            lambda: scratch.reach0.copy_(plist.reach0), reps)
        timing = (k4_ms, timed_ms(lambda: pairs_ops.research_dirty_plain(
            comb4, own_list(plist), *args4, **kw4), min(reps, 5)))
    # As K4's bound (check_research_dirty), with each dirty lane's id and
    # its candidates' ids read.
    gcap = grid4.capacity
    live_idx = dirty_idx[dirty_idx < n].long()
    slot = plist.pslot0[live_idx]
    cells = (slot[slot < grid4.num_cells * gcap] // gcap).long()
    rows = grid4.neighbors[cells].long()
    occ = (plist.idx0 < n).sum(dim=1)
    out["research_dirty"] = result(
        0.0, *timing,
        8 * int(bump[live_idx].sum()) + live_idx.numel() * 41
        + torch.unique(rows).numel() * gcap * 24 + 8 * appended,
        PAIR_TEST_OPS * int(occ[rows].sum()))
    if reps > 0:
        print_times(out, n, f"(slab forms, one of {SLABS} slabs' local and "
                    f"ghost lanes) {tag}")
    return out


def check_sharded_pairs_against_cpu(tag: str, particles: int = 20_000,
                                    steps: int = 10) -> None:
    """The 4-slab sharded pairs mode (K=8) on the card against the same on
    the CPU (which tests/test_torch_sharded_pairs.py holds to the JAX
    package), from one split state and one set of uniforms: valid, gid,
    counts, the rebuild steps and the histogram equal, the state within
    the cos/sin rounding of the two devices."""
    cpu = sharded_sim(particles, devices=["cpu"], steps_per_epoch=5, **PAIRS)
    gpu = sharded_sim(particles, steps_per_epoch=5, **PAIRS)
    state, meas, _ = cpu.init(SEED)
    n = cpu.cfg.num_molecules
    cap = cpu.plan.shard_capacity
    gen = torch.Generator().manual_seed(SEED)
    uniforms = torch.rand((steps, SLABS, cap, 2), generator=gen)
    s_c, m_c, met_c = cpu.run(steps, state=state, measure=meas,
                              draw=lambda s, i: uniforms[i, s])
    s_g, m_g, met_g = gpu.run(steps, state=to_card(state),
                              measure=to_card(meas),
                              draw=lambda s, i: uniforms[i, s].cuda())
    for f in ("collisions", "wall_hits", "oob_after_walls",
              "oob_after_pairs", "rebuilt"):
        exact(f"sharded pairs small run {f}", getattr(met_g, f).cpu(),
              getattr(met_c, f))
    t_c, t_g = cpu.finalize_measure(m_c), gpu.finalize_measure(m_g)
    for f in ("hist", "path_count", "collision_count", "err_count",
              "overflow_count", "halo_trunc_count", "hist_drop_count",
              "hot_spill_count"):
        exact(f"sharded pairs small run {f}", getattr(t_g, f).cpu(),
              getattr(t_c, f))
    rel = 0.0
    for k, ((st_g, v_g, g_g), (st_c, v_c, g_c)) in enumerate(zip(s_g, s_c)):
        exact(f"sharded pairs small run valid (slab {k})", v_g.cpu(), v_c)
        exact(f"sharded pairs small run gid (slab {k})", g_g.cpu()[v_c],
              g_c[v_c])
        exact(f"sharded pairs small run has_collided (slab {k})",
              st_g.has_collided.cpu()[v_c], st_c.has_collided[v_c])
        for f in ("pos", "vel", "paths"):
            a, b = getattr(st_g, f).cpu()[v_c], getattr(st_c, f)[v_c]
            rel = max(rel, float((a - b).abs().max() / b.abs().max()))
    require(rel <= 1e-5, f"sharded pairs small run: state differs by {rel} "
            f"relative")
    moved = int((slab_of_gid(s_g, n) != slab_of_gid(to_card(state), n)).sum())
    pairs = int((met_c.collisions - met_c.wall_hits).sum())
    require(moved > 0 and pairs > 0,
            f"sharded pairs small run: {moved} migrants, {pairs} pairs")
    print(f"sharded pairs small run vs CPU: N={n} slabs={SLABS} steps="
          f"{steps} K={gpu.pcfg.rebuild_interval} pairs={pairs} "
          f"wall_hits={int(met_c.wall_hits.sum())} migrated={moved} dirty="
          f"{met_g.dirty_count.tolist()} (CPU {met_c.dirty_count.tolist()}): "
          f"valid, gid, counts, rebuilds and histogram equal, state max rel "
          f"err {rel!r} (bound 1e-5) {tag}")


def sharded_counts_check(label, counts, expected, steps, rebuilds=0):
    """Each kernel's launches in a sharded run: ``expected`` maps a kernel
    to (a slab a step, a slab a rebuild)."""
    for name, (per_step, per_rebuild) in expected.items():
        want = SLABS * (per_step * steps + per_rebuild * rebuilds)
        require(counts.get(name, 0) == want,
                f"{label}: {name} launched {counts.get(name, 0)} times, "
                f"expected {want}")


def run_sharded_pairs_slice(tag: str, sweep_pairs: int) -> dict:
    """The sharded pairs mode at full width, counted: the 1M pore on 4
    slabs of the one card, K=8, 300 steps.  ``sweep_pairs`` is the sharded
    sweep's pair-collision total over the same steps from the same initial
    state (phase 8).  Every id live once after every epoch, no overflow
    after the first window, no halo truncation, pair collisions within 1%
    of the sharded sweep's, each kernel launched as often as its slab's
    steps and rebuilds ask."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = sharded_sim(steps_per_epoch=STEPS_PER_EPOCH, **PAIRS)
    state, meas, gens = sim.init(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sim.cfg.num_molecules
    k = sim.pcfg.rebuild_interval
    kernels.launch_counts.clear()
    # The first window alone, so that its overflow can be read.
    state, meas, first = sim.run(k, state=state, measure=meas,
                                 generators=gens)
    window0 = int(sim.finalize_measure(meas).overflow_count)
    slab_of_gid(state, n)
    epochs, seconds = [first], []
    step = k
    while step < STEPS:
        m = min(STEPS_PER_EPOCH, STEPS - step)
        t0 = time.perf_counter()
        state, meas, met = sim.run(m, state=state, measure=meas,
                                   generators=gens, start_step=step)
        torch.cuda.synchronize()
        seconds.append((m, time.perf_counter() - t0))
        slab_of_gid(state, n)
        epochs.append(met)
        step += m
    counts = dict(kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    metrics = StepMetrics.concat(epochs)
    tot = sim.finalize_measure(meas)
    for f in ("halo_trunc_count", "err_count"):
        require(int(getattr(tot, f)) == 0,
                f"sharded pairs slice: {f}={int(getattr(tot, f))}")
    require(int(tot.overflow_count) == window0,
            f"sharded pairs slice: overflow_count "
            f"{int(tot.overflow_count) - window0} after the first window")
    live = ParticleState(**{
        f.name: torch.cat([getattr(st, f.name)[valid]
                           for st, valid, _ in state])
        for f in dataclasses.fields(ParticleState)})
    require(all(bool(torch.isfinite(t).all())
                for t in (live.pos, live.vel, live.paths)),
            "sharded pairs slice: non-finite state")
    require(int(oob.pore_oob_count(live, sim.cfg.geometry)) == 0,
            "sharded pairs slice: particles out of bounds")
    pairs = int((metrics.collisions - metrics.wall_hits).sum())
    hits = int(metrics.wall_hits.sum())
    require(abs(pairs - sweep_pairs) <= 0.01 * sweep_pairs,
            f"sharded pairs slice: {pairs} pair collisions against the "
            f"sharded sweep's {sweep_pairs}")
    require(int(tot.collision_count) == pairs + hits,
            "sharded pairs slice: collision_count is not pairs + wall hits")
    require(int(tot.hist_drop_count) == 0 and bool(
        (tot.hist.sum(dim=1) == int(tot.path_count)).all()),
        "sharded pairs slice: histogram rows do not sum to path_count")
    rebuilds = int(metrics.rebuilt.sum())
    require(rebuilds == -(-STEPS // k), f"sharded pairs slice: {rebuilds} "
            f"rebuilds in {STEPS} steps")
    sharded_counts_check(
        "sharded pairs slice", counts,
        {"pore_advance": (1, 0), "test_and_resolve": (1, 0),
         "research_dirty": (1, 0), "flush_hist_compacted": (1, 0),
         "compact": (2, 1), "bin_and_table": (0, 1),
         "rebuild_sweep": (0, 1), "emit_pairs": (0, 1),
         "pack_indices": (0, 2), "pack_band_pair": (0, 1),
         "partner_sweep": (0, 0), "resolve_pairs": (0, 0),
         "flush_hist": (0, 0)}, STEPS, rebuilds)
    steady = (sum(m for m, _ in seconds[1:])
              / sum(t for _, t in seconds[1:]))
    print(f"sharded pairs slice: N={n} slabs={SLABS} K={k} steps={STEPS} "
          f"pairs={pairs} (sharded sweep {sweep_pairs}) wall_hits={hits} "
          f"path_count={int(tot.path_count)} overflow={window0}, all in the "
          f"first window, 0 after it; halo_trunc=0 err=0 oob=0 finite=True; "
          f"ids 0..N-1 live after every epoch; rebuilds={rebuilds} "
          f"hot_spill={int(tot.hot_spill_count)} dirty_count "
          f"{int(metrics.dirty_count.min())}-"
          f"{int(metrics.dirty_count.max())} {tag}")
    print(f"sharded pairs slice: particle-steps/s={steady * n!r} (after the "
          f"first window and epoch), step {1e3 / steady!r} ms, first epoch "
          f"after the first window {seconds[0][1]!r} s, init {init_s!r} s, "
          f"peak memory {peak / 2**30!r} GiB; lanes a slab "
          f"{sim.plan.shard_capacity} + 2 x {sim.plan.pairs_halo_capacity} "
          f"ghosts, {sim.plan.pairs_migration_capacity} migrant slots a "
          f"window {tag}")
    print(f"sharded pairs slice: launches {counts} {tag}")
    return counts


def run_sharded_cube(tag: str, one_card_mfp: float) -> dict:
    """The cube at its published size on the cell grid cut in 4 slabs of
    the card, 500 steps: kinetic energy within 1e-5, every id live once,
    no overflow or halo truncation, the pair rate the one-card cube's
    (snapshot overlaps, within 20%), the mean free path at the reference
    dt within 5% of the one-card cube's (``one_card_mfp``, phase 7); then
    the reference's mean-free-path check on 4 slabs (its validation
    configuration, 20 mean-free times): within 20% of lambda."""
    cfg = cube_on_cells(steps_per_epoch=100)
    sim = amt.ShardedSimulation(amt.make_workload(cfg), n_shards=SLABS)
    state, meas, gens = sim.init()
    n = cfg.num_molecules
    require(n == CUBE_PARTICLES, f"sharded cube: {n} particles")

    def energy(state):
        return sum(float((st.vel[v].double() ** 2).sum())
                   for st, v, _ in state)

    e0 = energy(state)
    kernels.launch_counts.clear()
    t0 = time.perf_counter()
    state, meas, metrics = sim.run(state=state, measure=meas, generators=gens)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(kernels.launch_counts)
    steps = cfg.num_timesteps
    slab_of_gid(state, n)
    tot = sim.finalize_measure(meas)
    for f in ("overflow_count", "halo_trunc_count", "err_count"):
        require(int(getattr(tot, f)) == 0,
                f"sharded cube: {f}={int(getattr(tot, f))}")
    e_rel = abs(energy(state) - e0) / e0
    require(e_rel <= 1e-5, f"sharded cube: kinetic energy moved by {e_rel}")
    g = cfg.geometry
    cr = cfg.physics.collision_range
    snapshot_rate = n * (n / g.volume) * (4.0 / 3.0) * math.pi * cr**3 / 2.0
    rate = int(metrics.collisions.sum()) / steps
    require(abs(rate - snapshot_rate) <= 0.2 * snapshot_rate,
            f"sharded cube: {rate} pairs a step against {snapshot_rate}")
    mfp = float(tot.path_sum[0]) / int(tot.path_count)
    require(abs(mfp - one_card_mfp) <= 0.05 * one_card_mfp,
            f"sharded cube: mean free path {mfp} against the one card's "
            f"{one_card_mfp}")
    sharded_counts_check(
        "sharded cube", counts,
        {"bin_and_table": (1, 0), "partner_sweep": (1, 0),
         "resolve_pairs": (1, 0), "flush_hist": (1, 0),
         "pack_band_pair": (2, 0), "compact": (1, 0),
         "allpairs_partner": (0, 0), "pore_advance": (0, 0)}, steps)
    lam = cfg.physics.lambda_mfp
    print(f"sharded cube: N={n} slabs={SLABS} steps={steps} pairs="
          f"{int(metrics.collisions.sum())} ({rate!r} a step; snapshot "
          f"expectation {snapshot_rate!r}) path_count={int(tot.path_count)} "
          f"mfp={mfp!r} m ({mfp / lam!r} lambda at the reference dt; one "
          f"card {one_card_mfp / lam!r}) kinetic energy rel change "
          f"{e_rel!r} (bound 1e-5); ids 0..N-1 live, overflow=0 "
          f"halo_trunc=0 err=0, halo capacity {sim.plan.halo_capacity}; "
          f"{seconds!r} s, {1e3 * seconds / steps!r} ms a step {tag}")
    print(f"sharded cube: launches {counts} {tag}")

    physics = amt.GasPhysics(sigma=3.6e-19 * 4.0)
    vgeom = amt.CubeGeometry(lx=40e-9, ly=40e-9, lz=40e-9)
    spm = max(1, int(round(physics.tau / (0.2e-9 / physics.v_mean))))
    vcfg = amt.CubeConfig(
        geometry=vgeom, physics=physics, nmft=20, steps_per_mft=spm,
        engine=amt.EngineConfig(broadphase="cells", steps_per_epoch=500))
    vsim = amt.ShardedSimulation(amt.make_workload(vcfg), n_shards=SLABS)
    t0 = time.perf_counter()
    vstate, vmeas, _ = vsim.run()
    torch.cuda.synchronize()
    vtot = vsim.finalize_measure(vmeas)
    count = int(vtot.path_count)
    measured = float(vtot.path_sum[0]) / count
    require(count > 3000, f"sharded mfp check: {count} completed paths")
    require(abs(measured - physics.lambda_mfp) <= 0.2 * physics.lambda_mfp,
            f"sharded mfp check: {measured} against lambda "
            f"{physics.lambda_mfp}")
    slab_of_gid(vstate, vcfg.num_molecules)
    print(f"sharded mfp check: N={vcfg.num_molecules} slabs={SLABS} steps="
          f"{vcfg.num_timesteps} paths={count} mfp={measured!r} m, lambda="
          f"{physics.lambda_mfp!r} m, ratio {measured / physics.lambda_mfp!r}"
          f" (bound 0.8-1.2), {time.perf_counter() - t0!r} s {tag}")
    return counts


def specular_config(particles=PARTICLES, **engine):
    return amt.PoreConfig(engine=amt.EngineConfig(
        broadphase="cells", **engine)).scaled_to(particles)


def with_ghost_rows(meas, gen, rows: int):
    """A copy of ``meas`` whose staging has ``rows`` more rows than
    particles, filled with draws (a slab's ghost rows)."""
    ghost = torch.rand((rows, 4), generator=gen, device="cuda")
    return dataclasses.replace(
        own(meas), pending_vals=torch.cat([meas.pending_vals, ghost]),
        pending_mask=torch.cat([meas.pending_mask, ghost[:, 0] > 0.5]))


def check_specular_pore(tag: str, steps: int = 100) -> None:
    """The specular pore on the card, one slab, 1M particles: a closed
    system without random draws, so its kinetic energy is constant;
    every wall hit and every pair collision ends a path (it stages a
    completed path or ends the particle's first, partial one)."""
    cfg = specular_config(steps_per_epoch=steps)
    sim = amt.Simulation(amt.make_workload(cfg), device="cuda")
    state, meas, gen = sim.init(SEED)
    e0 = kinetic(state)
    t0 = time.perf_counter()
    state, meas, metrics = sim.run(steps, state=state, measure=meas,
                                   generator=gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    e_rel = abs(kinetic(state) - e0) / e0
    require(e_rel <= 1e-5, f"specular pore: kinetic energy moved by {e_rel}")
    require(int(meas.err_count) == 0, "specular pore: wall-solver errors")
    require(bool(torch.isfinite(state.pos).all()),
            "specular pore: non-finite state")
    hits = int(metrics.wall_hits.sum())
    pairs = int((metrics.collisions - metrics.wall_hits).sum())
    events = hits + 2 * pairs
    ended = int(meas.path_count) + int(state.has_collided.sum())
    # A particle with two events in one step stages one path, so a few
    # events end no path of their own.
    require(hits > 0 and pairs > 0 and 0 <= events - ended <= 0.01 * events,
            f"specular pore: {events} events ended {ended} paths")
    nudged = int((metrics.oob_after_walls + metrics.oob_after_pairs).sum())
    print(f"specular pore: N={state.num_particles} steps={steps} "
          f"pairs={pairs} wall_hits={hits}; paths ended {ended} of {events} "
          f"events (the rest shared a step with another), nudged={nudged}, "
          f"err=0, kinetic energy rel change {e_rel!r} (bound 1e-5), "
          f"{state.num_particles * steps / seconds!r} particle-steps/s "
          f"{tag}")


def check_specular_pore_pairs(tag: str, steps: int = 100) -> dict:
    """The specular pore at 1M particles on the main path, pairs K = 8,
    replayed from CUDA graphs (the cell ``spore-1m.pairs``'s path): the
    replay bitwise the loop (``engine.replays_steps`` made to say no) in
    the state, the measurements, the ``StepMetrics`` and the carried pair
    list and its window; its kinetic energy constant and no wall-solver
    error, as ``check_specular_pore`` holds the sweep; K14 launched once a
    step.  Returns the replayed run's launches by kernel."""
    from argon_monte_carlo_tpu_torch import engine
    cfg = specular_config(steps_per_epoch=steps, **PAIRS)

    def run(replay: bool):
        sim = amt.Simulation(amt.make_workload(cfg), device="cuda")
        state, meas, gen = sim.init(SEED)
        e0 = kinetic(state)
        real = engine.replays_steps
        if not replay:
            engine.replays_steps = lambda *args: False
        kernels.launch_counts.clear()
        try:
            t0 = time.perf_counter()
            state, meas, metrics = sim.run(steps, state=state, measure=meas,
                                           generator=gen)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            engine.replays_steps = real
        launches = dict(kernels.launch_counts)
        plist, left = sim.pair_window()
        tensors = {f"{type(o).__name__}.{f.name}": getattr(o, f.name)
                   for o in (state, meas, metrics, plist)
                   for f in dataclasses.fields(o)}
        return sim, tensors, left, e0, seconds, launches

    sim, replayed, left, e0, seconds, launches = run(True)
    loop, looped, loop_left, _, loop_s, _ = run(False)
    require(sim.replayed_steps > 0 and loop.replayed_steps == 0,
            f"specular pore pairs: {sim.replayed_steps} steps replayed, "
            f"{loop.replayed_steps} in the loop")
    require(launches.get("specular_advance") == steps
            and "pore_advance" not in launches,
            f"specular pore pairs: launches {launches}")
    differ = [k for k in replayed if not torch.equal(replayed[k], looped[k])]
    require(not differ and left == loop_left,
            f"specular pore pairs: replay and loop differ in {differ}")
    e_rel = abs(float((replayed["ParticleState.vel"].double() ** 2).sum())
                - e0) / e0
    require(e_rel <= 1e-5,
            f"specular pore pairs: kinetic energy moved by {e_rel}")
    err = int(replayed["Measurements.err_count"])
    require(err == 0, f"specular pore pairs: {err} wall-solver errors")
    hits = int(replayed["StepMetrics.wall_hits"].sum())
    pairs = int((replayed["StepMetrics.collisions"]
                 - replayed["StepMetrics.wall_hits"]).sum())
    require(hits > 0 and pairs > 0,
            f"specular pore pairs: {hits} wall hits, {pairs} pairs")
    print(f"specular pore pairs: N={cfg.num_molecules} steps={steps} K=8 "
          f"replayed={sim.replayed_steps} looped={sim.looped_steps}: "
          f"replay bitwise the loop in {len(replayed)} tensors and the "
          f"window ({left} left); pairs={pairs} wall_hits={hits} err=0, "
          f"kinetic energy rel change {e_rel!r} (bound 1e-5), "
          f"{cfg.num_molecules * steps / seconds!r} particle-steps/s "
          f"replayed, {cfg.num_molecules * steps / loop_s!r} looped (first "
          f"runs: graphs captured, kernels' first calls); specular_advance "
          f"launched {launches['specular_advance']} times {tag}")
    return launches


SPECULAR_GHOST_ROWS = 4099


def check_specular_advance(tag: str, particles: int = PARTICLES,
                           steps: int = 16, reps: int = 20,
                           require_cases: bool = True) -> dict:
    """K14 against its plain twin on the card, over ``steps`` steps of the
    specular pore's pairs slice after its first 24: each step's state goes
    through both, K14 on copies with SPECULAR_GHOST_ROWS staging rows past
    the particles and the audit on, and once more on plain copies without
    it; every output bitwise the twin's (the ledger's zeros included), the
    audit's counts equal to the plain audit's, the launch without the
    audit bitwise the one with it, the tensors given returned and the rows
    past the particles as they were; every wall case takes lanes (with
    ``require_cases``).  Then
    its time a call in place, its device time, and its bound
    (``bench_torch/counts/walls.py``: K8's in-place count with no
    energized lane)."""
    cfg = specular_config(particles, **PAIRS)
    sim = amt.Simulation(amt.make_workload(cfg), device="cuda")
    wl = sim.workload
    state, meas, gen = sim.init(SEED)
    start = 24
    state, meas, _ = sim.run(start, state=state, measure=meas, generator=gen)
    n = state.num_particles
    cases = Counter()
    audit = torch.zeros(10, dtype=torch.int64)
    for i in range(steps):
        u = torch.rand((n, 2), generator=gen, device="cuda")
        masks = {}
        want_missed = torch.zeros(10, dtype=torch.int32, device="cuda")
        want = wl.advance_plain(state, meas, u, masks, missed=want_missed)
        ks, km = own(state), with_ghost_rows(meas, gen, SPECULAR_GHOST_ROWS)
        ghost = [t[n:].clone() for t in (km.pending_vals, km.pending_mask)]
        missed = torch.zeros(10, dtype=torch.int32, device="cuda")
        got = wl.advance(ks, km, u, missed=missed)
        require(got[0] is ks and got[1] is km,
                "K14: not the state and measurements given")
        same_tensors(got[0], ks, "K14")
        same_tensors(got[1], km, "K14")
        again = wl.advance(own(state), own(meas), u)
        g, w, a = (k8_outputs(o) for o in (got, want, again))
        for name in g:
            gt, wt, at = (o[name][:n] if name.startswith("pending")
                          else o[name] for o in (g, w, a))
            require(bits_equal(gt, wt.to(gt.dtype)),
                    f"K14 {name} (step {i}): != plain")
            require(bits_equal(gt, at), f"K14 {name} (step {i}): the launch "
                    f"with the audit != the launch without it")
        exact(f"K14 audit counts (step {i})", missed, want_missed)
        require(all(bits_equal(t[n:], kept) for t, kept in zip(
            (km.pending_vals, km.pending_mask), ghost)),
            f"K14 (step {i}): a staging row past the particles changed")
        for name, m in masks.items():
            cases[name] += int(m.sum())
        audit += missed.cpu().long()
        state, meas, _ = sim.run(1, state=state, measure=meas,
                                 start_step=start + i, draw=lambda _: u)
    groups = Counter()
    for name, count in cases.items():
        groups[name[0]] += count
    if require_cases:
        for grp in "123456":
            require(groups[grp] > 0, f"K14: case {grp} took no particle")
    print(f"K14 specular_advance: {steps} steps at N={n}; particles per case "
          f"(plain masks) {dict(sorted(cases.items()))}; audit counts "
          f"{dict(zip(amt.models.base.AUDIT_CASES, audit.tolist()))} {tag}")
    print(f"K14 specular_advance: state, staging, masks, speed_pre, recap_w, "
          f"hits, errs, nudged and the ledger's zeros bitwise the plain "
          f"version's; the audit's counts equal; with the audit bitwise "
          f"without it; in place (the state and staging given, returned), "
          f"{SPECULAR_GHOST_ROWS} staging rows past the particles as they "
          f"were {tag}")
    hits = sum(cases.values()) // steps
    nbytes = k8.bytes_in_place(n, hits, 0)
    u = torch.rand((n, 2), generator=gen, device="cuda")
    out = {"specular_advance": result(
        0.0, None, maybe_timed(lambda: wl.advance_plain(state, meas, u),
                               min(reps, 3)),
        nbytes, k8.OPS_PER_PARTICLE * n)}
    if reps > 0:
        ks, km = own(state), own(meas)

        def reset():
            refill(ks, state)
            refill(km, meas)

        def call():
            wl.advance(ks, km, u)

        ms, reset_ms, spread = net_ms(call, reset, reps)
        device_us, launches = device_per_call(call, reset)
        out["specular_advance"]["ms"] = ms
        print(f"K14 specular_advance at N={n}: {ms!r} ms a call in place "
              f"(median of {spread!r}, net of a {reset_ms!r} ms reset), "
              f"device {device_us!r} us in {launches!r} launches a call; "
              f"bound {out['specular_advance']['bound_ms']!r} ms (bytes "
              f"{nbytes}, {hits} wall-case lanes a step, counts/walls.py): "
              f"{100 * out['specular_advance']['bound_ms'] / ms!r}% of it by "
              f"the wrapper's time, "
              f"{100e3 * out['specular_advance']['bound_ms'] / device_us!r}%"
              f" by the device's {tag}")
        print_times(out, n, tag)
    return out


AUDIT_STEPS = 8


def check_pore_advance_audit(tag: str, particles: int = PARTICLES,
                             steps: int = AUDIT_STEPS,
                             timed: bool = True) -> None:
    """K8 with the missed-case audit, over ``steps`` steps of the pairs
    slice at 1M particles after its first 24: the kernel's ten counts
    exactly equal to the plain audit of the twin's post-wall state, and
    its state, staging, ledger and counts bitwise equal to K8 without the
    audit; then K8's device time a call with the audit and without."""
    cfg = config(particles, **PAIRS)
    sim = amt.Simulation(amt.make_workload(cfg), device="cuda")
    wl = sim.workload
    state, meas, gen = sim.init(SEED)
    start = 24
    state, meas, _ = sim.run(start, state=state, measure=meas, generator=gen)
    n = state.num_particles
    totals = torch.zeros(10, dtype=torch.int64)
    for i in range(steps):
        u = torch.rand((n, 2), generator=gen, device="cuda")
        off = wl.advance(own(state), own(meas), u)
        got = torch.zeros(10, dtype=torch.int32, device="cuda")
        on = wl.advance(own(state), own(meas), u, missed=got)
        want = torch.zeros(10, dtype=torch.int32, device="cuda")
        wl.advance_plain(state, meas, u, missed=want)
        exact(f"K8 audit counts (step {i})", got, want)
        a, b = k8_outputs(on), k8_outputs(off)
        for name in a:
            require(torch.equal(a[name], b[name]),
                    f"K8 {name} with the audit != without (step {i})")
        totals += got.cpu().long()
        state, meas, _ = sim.run(1, state=state, measure=meas,
                                 start_step=start + i, draw=lambda _: u)
    cases = dict(zip(amt.models.base.AUDIT_CASES, totals.tolist()))
    print(f"K8 pore_advance with the audit: {steps} steps at N={n}: the ten "
          f"counts exact against the plain audit of the twin's post-wall "
          f"state (summed over the steps: {cases}); state, staging, ledger "
          f"and counts bitwise equal to K8 without the audit {tag}")
    if not timed:
        return
    u = torch.rand((n, 2), generator=gen, device="cuda")
    missed = torch.zeros(10, dtype=torch.int32, device="cuda")
    ks, km = own(state), own(meas)

    def reset():
        refill(ks, state)
        refill(km, meas)
        missed.zero_()

    off_us, off_l = device_per_call(lambda: wl.advance(ks, km, u), reset)
    on_us, on_l = device_per_call(
        lambda: wl.advance(ks, km, u, missed=missed), reset)
    print(f"breakdown K8: pore_advance {off_us!r} us of device time a call "
          f"in {off_l!r} launches without the audit, {on_us!r} us in "
          f"{on_l!r} with it, at N={n} {tag}")


def cube_on_cells(steps_per_epoch: int = 100) -> amt.CubeConfig:
    """The published cube on the cell grid (a grid centred on the box)."""
    cfg = cube_config(steps_per_epoch=steps_per_epoch)
    return dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, broadphase="cells"))


def check_k2_cube(tag: str, reps: int = 20) -> None:
    """K2 on the cube's centred grid at its published 24,627 particles
    (one drift after init), exact against its twin, with its times."""
    cfg = cube_on_cells()
    sim = amt.Simulation(amt.make_workload(cfg), device="cuda")
    grid = sim.grid
    state, _, _ = sim.init()
    pos = state.pos + cfg.dt * state.vel
    n = pos.shape[0]
    require(n == CUBE_PARTICLES, f"cube: {n} particles")
    require(grid.center_x == cfg.geometry.lx / 2.0
            and grid.center_y == cfg.geometry.ly / 2.0,
            "cube grid: not centred on the box")
    got = check_k2("cube grid, centred", pos, grid)
    uncentred = dataclasses.replace(grid, center_x=0.0, center_y=0.0)
    require(not torch.equal(collide.bin_and_table(pos, uncentred)[0], got[0]),
            "K2: the centre changed no cell id")
    print(f"K2 bin_and_table on the cube's centred grid: exact at N={n} "
          f"({grid.num_cells} cells, capacity {grid.capacity}, overflow "
          f"{int(got[3])}) {tag}")
    if reps <= 0:
        return
    ms = timed_ms(lambda: collide.bin_and_table(pos, grid), reps)
    plain_ms = timed_ms(lambda: collide.bin_and_table_plain(pos, grid), 3)
    nbytes = tensor_bytes(pos, got)
    us, launches = device_per_call(lambda: collide.bin_and_table(pos, grid),
                                   lambda: None)
    print(f"K2 bin_and_table on the cube's centred grid: kernel {ms!r} ms "
          f"(device {us!r} us in {launches!r} launches), plain {plain_ms!r} "
          f"ms, bound {nbytes / HBM_BYTES_PER_S * 1e3!r} ms (bytes) at N={n} "
          f"{tag}")


def compare_cube_cells_with_allpairs(tag: str, steps: int = 100) -> None:
    """The published cube on the cell grid (K2, K9) against the cube on
    the all-pairs search (K11), 100 steps from one seed: both find each
    particle's lowest-index partner within range, so the states must be
    bitwise equal and the counts equal."""
    runs = {}
    for label, cfg in (("allpairs", cube_config(steps_per_epoch=50)),
                       ("cells", cube_on_cells(steps_per_epoch=50))):
        sim = amt.Simulation(amt.make_workload(cfg), device="cuda")
        state, meas, gen = sim.init()
        kernels.launch_counts.clear()
        runs[label] = sim.run(steps, state=state, measure=meas,
                              generator=gen)
        torch.cuda.synchronize()
        runs[label] += (dict(kernels.launch_counts),)
    (sa, ma, meta, _), (sc, mc, metc, cc) = runs["allpairs"], runs["cells"]
    for f in ("pos", "vel", "paths", "has_collided"):
        require(torch.equal(getattr(sa, f), getattr(sc, f)),
                f"cube on cells: {f} differs from allpairs")
    for f in ("hist", "path_sum", "path_count", "collision_count",
              "err_count"):
        require(torch.equal(getattr(ma, f), getattr(mc, f)),
                f"cube on cells: {f} differs from allpairs")
    require(torch.equal(meta.collisions, metc.collisions),
            "cube on cells: per-step collisions differ")
    require(int(mc.overflow_count) == 0, "cube on cells: cell overflow")
    for name in ("bin_and_table", "partner_sweep"):
        require(cc.get(name, 0) == steps,
                f"cube on cells: {name} launched {cc.get(name, 0)} times")
    print(f"cube on cells vs allpairs: {steps} steps at N={sc.num_particles}:"
          f" state bitwise equal, collisions {int(mc.collision_count)} and "
          f"paths {int(mc.path_count)} equal, overflow 0; cells launched "
          f"{ {k: cc[k] for k in sorted(cc)} } {tag}")


CLI_CHECKED = ("pos", "vel", "paths", "has_collided", "hist", "path_sum",
               "path_count", "collision_count")


def run_cli(label: str, argv, tag: str) -> str:
    """``cli.main(argv)`` in this process on the card; returns what it
    printed and prints one line with its wall time."""
    import contextlib
    import io as io_module

    from argon_monte_carlo_tpu_torch import cli

    out = io_module.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(list(argv))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    text = out.getvalue()
    require(rc == 0, f"CLI {label}: exit code {rc}")
    last = [line for line in text.splitlines()
            if line.startswith(("total collisions", "runtime"))]
    print(f"CLI {label}: {seconds!r} s wall; {' | '.join(last)} {tag}")
    return text


def check_cli(tag: str) -> None:
    """The user surface on the card: ``cli.main`` in-process, the main path
    at its default 557,649 molecules (pairs, K=8) for 200 steps with a
    checkpoint every 100, then a resume from step 100 (mid-window) into a
    second directory; their step-200 checkpoints bitwise equal, rows
    100-199 of the first CSV equal the resumed run's rows, the 8 histogram
    files parse, metrics carry device_memory.  Then short runs of the
    audit, the 4-slab sharded sweep, the 4-slab sharded pairs mode at 200k
    with a resume from step 20 (mid-window) whose step-40 checkpoint is
    bitwise the whole run's, the cube on cells and the cube on 4 slabs."""
    import shutil
    import tempfile

    from argon_monte_carlo_tpu_torch.io import writers

    root = Path(tempfile.mkdtemp(prefix="amc_cli_"))
    try:
        first, second = root / "first", root / "second"
        common = ["--steps-per-epoch", "50", "--checkpoint-every", "100"]
        run_cli("temperature_pore, 200 steps",
                ["temperature_pore", "--steps", "200", "--out", str(first)]
                + common, tag)
        text = run_cli(
            "temperature_pore, resumed at step 100 for 100 steps",
            ["temperature_pore", "--steps", "100", "--out", str(second),
             "--resume", str(first / "checkpoint_00000100.npz")] + common,
            tag)
        require("resumed from" in text, "CLI: no resume line")
        with np.load(first / "checkpoint_00000200.npz") as a, \
                np.load(second / "checkpoint_00000200.npz") as b:
            for f in CLI_CHECKED:
                require(np.array_equal(a[f], b[f]),
                        f"CLI: the resumed run's step-200 {f} differs")
            require(str(a["generator_device"]) == "cuda",
                    "CLI: the generator state is not the card's")
            n = a["pos"].shape[0]
            collisions = int(a["collision_count"])
        whole = writers.read_momentum_energy_csv(
            str(first / "momentum_energy.csv"))
        tail = writers.read_momentum_energy_csv(
            str(second / "momentum_energy.csv"))
        require(len(whole["index"]) == 200 and len(tail["index"]) == 100,
                "CLI: CSV rows")
        for name in writers.CSV_COLUMNS:
            require(np.array_equal(whole[name][100:], tail[name]),
                    f"CLI: CSV {name} rows 100-199 differ from the resumed "
                    f"run's")
        for name in writers.AXIS_NAMES:
            edges = writers.read_reference_histogram(
                str(first / f"hist_x_axis_{name}_data.txt"))
            dens = writers.read_reference_histogram(
                str(first / f"hist_y_axis_{name}_data.txt"))
            # The files print 8 significant digits (numpy's str).
            total = float((dens * (edges[1] - edges[0])).sum())
            require(edges.shape == dens.shape == (200,)
                    and abs(total - 1.0) < 1e-6,
                    f"CLI: histogram {name} integrates to {total!r}")
        records = [json.loads(line) for line in
                   (first / "metrics.jsonl").read_text().splitlines()]
        require(len(records) == 4 and all("device_memory" in r
                                           for r in records),
                "CLI: metrics.jsonl lacks device_memory")
        mem = records[-1].get("device_memory")
        print(f"CLI: N={n}, step-200 checkpoints of the whole and the "
              f"resumed run bitwise equal in {', '.join(CLI_CHECKED)} "
              f"({collisions} collisions); CSV rows 100-199 equal; 8 "
              f"histogram files parse and integrate to 1; device_memory "
              f"{mem} {tag}")
        text = run_cli("temperature_pore --debug-audits, 20 steps",
                       ["temperature_pore", "--debug-audits", "--steps", "20",
                        "--out", str(root / "audit")], tag)
        require("total collisions" in text, "CLI: audit run")
        run_cli("temperature_pore --mesh 4 --narrowphase sweep, 20 steps",
                ["temperature_pore", "--mesh", "4", "--narrowphase", "sweep",
                 "--steps", "20", "--out", str(root / "mesh")], tag)
        # The sharded pairs mode (the pores' default narrow phase) with a
        # checkpoint mid-window and a resume from it.
        whole, resumed = root / "mesh_pairs", root / "mesh_pairs_resumed"
        mesh = ["temperature_pore", "--mesh", "4", "--target-particles",
                "200000", "--steps-per-epoch", "20", "--checkpoint-every",
                "20"]
        run_cli("temperature_pore --mesh 4 (pairs, K=8), 40 steps",
                mesh + ["--steps", "40", "--out", str(whole)], tag)
        run_cli("temperature_pore --mesh 4, resumed at step 20 for 20 steps",
                mesh + ["--steps", "20", "--out", str(resumed), "--resume",
                        str(whole / "checkpoint_00000020.npz")], tag)
        with np.load(whole / "checkpoint_00000040.npz") as a, \
                np.load(resumed / "checkpoint_00000040.npz") as b:
            names = [f if f in a.files else f"m_{f}" for f in CLI_CHECKED]
            for f in names + ["valid", "gid", "pairs_a", "pairs_cursor",
                              "pairs_window_left"]:
                require(np.array_equal(a[f], b[f]),
                        f"CLI --mesh 4: the resumed run's step-40 {f} "
                        f"differs")
            m = int(a["valid"].sum())
            mesh_collisions = int(a["m_collision_count"].sum())
        print(f"CLI --mesh 4: N={m}, step-40 checkpoints of the whole and "
              f"the resumed sharded pairs run (resumed at step 20, mid-"
              f"window) bitwise equal in the state, the measurements, valid, "
              f"gid and the slabs' pair lists ({mesh_collisions} "
              f"collisions) {tag}")
        run_cli("cube --broadphase cells, 50 steps",
                ["cube", "--broadphase", "cells", "--steps", "50",
                 "--out", str(root / "cube")], tag)
        run_cli("cube --mesh 4 (cells), 50 steps",
                ["cube", "--mesh", "4", "--steps", "50",
                 "--out", str(root / "cube_mesh")], tag)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def our_kernel_names() -> set:
    """The __global__ function names of the port's CUDA sources and
    headers."""
    names = set()
    for src in kernels.CSRC.glob("*.cu*"):
        names.update(re.findall(r"__global__\s+void\s+(\w+)",
                                src.read_text()))
    return names


def kernel_short_name(name: str, ours: set) -> str:
    """The port's kernel a device event ran, found by its name in the
    demangled or the mangled symbol; else the first identifier followed
    by '<' or '(' ('void at::native::elementwise_kernel<...>(...)' ->
    'elementwise_kernel'); 'Memcpy DtoD (Device -> Device)' ->
    'Memcpy DtoD'."""
    if name.startswith(("Memcpy", "Memset")):
        return name.split(" (")[0]
    for k in ours:
        if re.search(rf"(?<![A-Za-z_]){k}(?![a-z0-9_])", name):
            return k
    m = re.search(r"([A-Za-z_]\w*)\s*[<(]", name)
    return m.group(1) if m else name[:48]


def breakdown(tag: str, label: str, cfg, traced: int = 16,
              timed: int = 40, profiled: int = 24, n_shards=None) -> None:
    """Phase 9: where one slice's step time goes.  Untraced step time from
    CUDA events; device time, its share in the port's kernels and device
    operations a step from torch.profiler; host time of the step and of
    its per-particle stage (``advance``) from cProfile.  With ``n_shards``
    the slice is the sharded sweep with that many slabs on the card."""
    from torch.profiler import ProfilerActivity, profile
    if n_shards is None:
        sim = amt.Simulation(amt.make_workload(cfg), device="cuda")
        draws = "generator"
    else:
        sim = amt.ShardedSimulation(amt.make_workload(cfg),
                                    n_shards=n_shards)
        draws = "generators"
    state, meas, gen = sim.init(SEED)
    step = 0

    def run(k):
        nonlocal state, meas, step
        state, meas, _ = sim.run(k, state=state, measure=meas,
                                 start_step=step, **{draws: gen})
        step += k

    run(24)

    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    run(timed)
    ev[1].record()
    torch.cuda.synchronize()
    step_ms = ev[0].elapsed_time(ev[1]) / timed

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(traced)
        torch.cuda.synchronize()
    ours = our_kernel_names()
    device_us, ours_us, ops = 0.0, 0.0, 0
    by_name = Counter()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        device_us += us
        ops += 1
        short = kernel_short_name(e.name, ours)
        by_name[short] += us
        if short in ours:
            ours_us += us
    require(ours_us > 0, f"breakdown {label}: no device time in the port's "
            f"kernels")
    device_ms = device_us / 1e3 / traced
    top = ", ".join(f"{k} {v / 1e3 / traced:.3f}"
                    for k, v in by_name.most_common(8))
    port = ", ".join(f"{k} {v / 1e3 / traced:.4f}"
                     for k, v in by_name.most_common() if k in ours)

    torch.cuda.synchronize()
    prof_host = cProfile.Profile()
    t0 = time.perf_counter()
    prof_host.enable()
    run(profiled)
    prof_host.disable()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / profiled
    stats = pstats.Stats(prof_host)
    # Host time of the per-particle stage: the workload's advance, and the
    # plain wall pass (inside advance on the CPU; called by the step itself
    # before K8).
    stage = {name: sum(v[3] for k, v in stats.stats.items()
                       if k[2] == name) * 1e3 / profiled
             for name in ("advance", "wall_pass")}
    print(f"breakdown {label}: step {step_ms!r} ms untraced; device "
          f"{device_ms!r} ms a step ({device_ms / step_ms:.1%} busy, idle "
          f"{1 - device_ms / step_ms:.1%}), {ops / traced:.1f} device ops a "
          f"step, port kernels {ours_us / 1e3 / traced!r} ms a step; host "
          f"{host_ms!r} ms a step under cProfile, advance "
          f"{stage['advance']!r} ms, plain wall pass {stage['wall_pass']!r} "
          f"ms {tag}")
    print(f"breakdown {label}: device ms a step by kernel: {top} {tag}")
    print(f"breakdown {label}: device ms a step by port kernel: {port} "
          f"{tag}")


def time_compact(tag: str, reps: int = 200) -> None:
    """K6's wrapper beside ``torch.nonzero`` at the pairs step's shared
    compaction (one small launch, too short for the breakdown's list), so
    that two checkouts read in one call compare on it too."""
    dev = torch.device("cuda")
    n = config().num_molecules
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    mask = torch.rand(n, generator=gen, device=dev) < 3e-3
    shared = max(measure_ops.FLUSH_CAPACITY, n // 64)
    ms = [timed_ms(lambda: compact.compact_indices(mask, shared, n), reps)
          for _ in range(3)]
    lib = [timed_ms(lambda: torch.nonzero(mask), reps) for _ in range(3)]
    print(f"breakdown K6: compact_indices {ms!r} ms a call, torch.nonzero "
          f"{lib!r} ms (mean of {reps}, three times) at N={n} {tag}")


def time_k2_k12(tag: str, reps: int = 20) -> None:
    """K2 at 1M and on one slab's local and ghost lanes, and K12 on that
    slab's two halo bands, each three times (CUDA events, mean of
    ``reps``), K12 beside the library calls for the same work (the masks,
    ``torch.nonzero`` and one ``index_select`` a field, both directions):
    so that two checkouts read in one call compare on them.  K12 is the
    two-direction entry where the checkout has it, else two one-direction
    calls on masks built as that checkout's step builds them."""
    dev = torch.device("cuda")
    cfg = config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    state = init_ops.init_pore(cfg, gen, dev)
    pos = state.pos + cfg.dt * state.vel
    _, grid = build_grids(amt.make_workload(cfg), dev)
    k2 = [timed_ms(lambda: collide.bin_and_table(pos, grid), reps)
          for _ in range(3)]
    case = slab_case()
    c, fields, valid = case.c, case.band, case.valid
    cap = case.plan.halo_capacity
    k2_slab = [timed_ms(lambda: collide.bin_and_table(
        case.pos, c.grid, valid=case.lanes), reps) for _ in range(3)]
    if hasattr(pack, "pack_band_pair"):
        form = "pack_band_pair (both bands, one call)"

        def k12():
            pack.pack_band_pair(fields, valid, cap, c.up_edge, c.down_edge)
    else:
        form = "two pack_band calls on their masks"

        def k12():
            z = fields["pos"][:, 2]
            pack.pack_band(fields, valid & (z > c.up_edge), cap)
            pack.pack_band(fields, valid & (z < c.down_edge), cap)

    def library():
        z = fields["pos"][:, 2]
        for m in (valid & (z > c.up_edge), valid & (z < c.down_edge)):
            idx = torch.nonzero(m).flatten()[:cap]
            for a in fields.values():
                torch.index_select(a, 0, idx)

    k12_ms = [timed_ms(k12, reps) for _ in range(3)]
    lib_ms = [timed_ms(library, reps) for _ in range(3)]
    print(f"breakdown K2: bin_and_table {k2!r} ms at N={pos.shape[0]}, "
          f"{k2_slab!r} ms on {case.pos.shape[0]} slab lanes (mean of "
          f"{reps}, three times) {tag}")
    print(f"breakdown K12: {form} {k12_ms!r} ms, library {lib_ms!r} ms "
          f"(mean of {reps}, three times) on {valid.shape[0]} slab lanes "
          f"{tag}")


def device_per_call(call, reset, calls: int = 20) -> tuple:
    """(device us, launches) a call in the port's kernels, from
    torch.profiler over ``calls`` calls, each after ``reset()`` (copies,
    not counted)."""
    from torch.profiler import ProfilerActivity, profile
    reset()
    call()
    torch.cuda.synchronize()
    ours = our_kernel_names()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            reset()
            call()
        torch.cuda.synchronize()
    us, launches = 0.0, 0
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and kernel_short_name(e.name, ours) in ours):
            us += e.time_range.elapsed_us()
            launches += 1
    return us / calls, launches / calls


def time_k7_k11(tag: str) -> None:
    """K7's dense entry and K11 alone, device time and launches a call:
    K7 at 1M particles with 5,000 staged (a sweep step's order) at the
    flush capacity and on one slab's lanes at its own capacity, K11 on the
    cube's 24,627 particles; so that two checkouts read in one call
    compare on them.  Each K7 call is given the same staging again."""
    dev = torch.device("cuda")
    cfg = config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    nb, hi = cfg.engine.num_bins, cfg.engine.hist_range[1]
    host_grid, _ = build_grids(amt.make_workload(cfg), dev)
    lanes = slab_lanes(cfg, host_grid)
    for n, cap, label in ((cfg.num_molecules, measure_ops.FLUSH_CAPACITY,
                           "1M"), (lanes, lanes, "a slab")):
        given = k7_staging(Measurements.zeros(nb, torch.float32, n, dev),
                           gen, 5000 / n)
        mine = own(given)
        us, launches = device_per_call(
            lambda: measure_ops.flush_hist(mine, nb, hi, capacity=cap),
            lambda: refill(mine, given))
        print(f"breakdown K7: flush_hist {us!r} us of device time a call in "
              f"{launches!r} launches, {label} ({n} rows, "
              f"{int(given.pending_mask.sum())} staged, capacity {cap}) "
              f"{tag}")
    cube = cube_config()
    gen.manual_seed(cube.seed)
    state = init_ops.init_cube(cube, gen)
    pos = state.pos + cube.dt * state.vel
    r = cube.physics.collision_range + cube.engine.skin
    us, launches = device_per_call(
        lambda: collide.allpairs_partner_search(pos, r,
                                                cube.engine.allpairs_tile),
        lambda: None)
    print(f"breakdown K11: allpairs_partner {us!r} us of device time a call "
          f"in {launches!r} launches at N={pos.shape[0]} {tag}")


def time_k10_k5(tag: str) -> None:
    """K10 and K5 alone, device time and launches a call: K10 at 1M
    particles one drift after init with its partners from K9 (each call
    on a copy of the same inputs, refilled before it and then a read of
    64 MB, so that the refill's dirty lines leave the 50 MB L2 before the
    call, as they are gone in a step; neither is counted), K5 on the main
    path's rebuild candidates at 1M; so that two checkouts read in one
    call compare on them.  K10 is the in-place form where the checkout
    has it (a ``count`` argument), else the copying one."""
    dev = torch.device("cuda")
    cfg = config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    state = init_ops.init_pore(cfg, gen, dev)
    state = dataclasses.replace(state, pos=state.pos + cfg.dt * state.vel)
    _, grid = build_grids(amt.make_workload(cfg), dev)
    r = cfg.physics.collision_range
    _, table, pslot, _ = collide.bin_and_table(state.pos, grid)
    partner = collide.partner_sweep(state.pos, table, pslot, grid, r)
    u = torch.rand((state.num_particles, 6), generator=gen, device=dev)
    state = dataclasses.replace(state, paths=u[:, :4] * 2e-7,
                                has_collided=u[:, 4] < 0.6)
    meas = Measurements.zeros(cfg.engine.num_bins, torch.float32,
                              state.num_particles, dev)
    meas = dataclasses.replace(meas, pending_vals=u[:, :4].flip(1) * 1e-6,
                               pending_mask=u[:, 5] < 0.1)
    ts, tm = own(state), own(meas)
    if "count" in inspect.signature(collide.resolve_pairs).parameters:
        form = "in place"
        count = torch.zeros((), dtype=torch.int32, device=dev)

        def k10():
            collide.resolve_pairs(ts, tm, partner, r, count=count)
    else:
        form = "copying"

        def k10():
            collide.resolve_pairs(ts, tm, partner, r)

    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)

    def reset():
        refill(ts, state)
        refill(tm, meas)
        flush.sum()

    us, launches = device_per_call(k10, reset)
    print(f"breakdown K10: resolve_pairs ({form}) {us!r} us of device time "
          f"a call in {launches!r} launches of the port's kernels at "
          f"N={state.num_particles} {tag}")
    case = pairs_case()
    pcfg, grid = case.pcfg, case.grid
    reach, clipped = pairs_ops.reach_radii(
        case.state.vel, case.cr, case.dt, pcfg.rebuild_interval,
        0.5 * grid.cell_size)
    _, table, pslot, overflow = collide.bin_and_table(case.state.pos, grid)
    cands, unswept, _, _ = collide.rebuild_sweep(case.state.pos, reach,
                                                 table, pslot, grid,
                                                 pcfg.top_k)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    args = (cands, pslot, clipped, unswept, overflow, zero, zero,
            grid.num_cells * grid.capacity, pcfg.pair_capacity)
    us, launches = device_per_call(lambda: pairs_ops.emit_pairs(*args),
                                   lambda: None)
    print(f"breakdown K5: emit_pairs {us!r} us of device time a call in "
          f"{launches!r} launches of the port's kernels at N={case.n}, "
          f"{int((cands >= 0).sum())} entries, pair_capacity "
          f"{pcfg.pair_capacity} {tag}")


def breakdowns(tag: str) -> None:
    """Phase 9 for every slice this checkout has."""
    time_compact(tag)
    time_k2_k12(tag)
    time_k7_k11(tag)
    time_k10_k5(tag)
    breakdown(tag, "sweep", config())
    breakdown(tag, "pairs", config(**PAIRS))
    if hasattr(amt, "CubeConfig"):
        breakdown(tag, "cube", cube_config())
    if hasattr(amt, "ShardedSimulation"):
        for n_shards in (1, 2, SLABS):
            breakdown(tag, f"sharded sweep, {n_shards} slab(s)", config(),
                      n_shards=n_shards)
        if hasattr(amt.ShardedSimulation, "pair_window"):
            for n_shards in (1, 2, SLABS):
                breakdown(tag, f"sharded pairs, {n_shards} slab(s)",
                          config(**PAIRS), n_shards=n_shards)
            breakdown(tag, f"sharded cube, {SLABS} slabs", cube_on_cells(),
                      n_shards=SLABS)


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--breakdown", action="store_true",
        help="run only phases 0, 1 and 9 and print no result line (a copy "
             "of this script beside another checkout's package reads that "
             "checkout the same way)")
    args = parser.parse_args(argv)
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
    if args.breakdown:
        breakdowns(tag)
        return 0
    check_ledger_gate(tag)
    check_ledger_gate(tag, n_shards=SLABS)
    results = check_kernels(tag)
    results.update(check_pairs_kernels(tag))
    results.update(check_pore_advance(tag))
    for audit, extra_rows in ((False, 0), (True, 4099)):
        check_pore_advance_in_place(tag, audit=audit, extra_rows=extra_rows)
    check_pore_advance_graph(tag)
    check_pore_advance_audit(tag)
    time_pore_advance_at(tag, 10_000_000)
    results.update(check_specular_advance(tag))
    results.update(check_post_pairs(tag))
    check_post_pairs_graph(tag)
    results.update(check_allpairs(tag))
    check_k2_cube(tag)
    results.update(check_slab(tag))
    for name, r in check_sharded_pairs_kernels(tag).items():
        results[name]["slab_form"] = r
    check_against_cpu(tag)
    check_against_cpu(tag, narrowphase="pairs", rebuild_interval=5)
    check_against_cpu(tag, cfg=cube_config(3_000, steps_per_epoch=5),
                      label="cube", steps=20)
    check_sharded_against_cpu(tag)
    check_sharded_pairs_against_cpu(tag)
    compare_pairs_with_sweep(tag)
    # Each path's launches, counted from zero just before it runs.
    paths = {}
    paths["sweep"], sweep_pairs = run_slice(tag, [*KERNELS, *WALL_KERNELS])
    paths["pairs"], _ = run_slice(
        tag, ["bin_and_table", *PAIRS_KERNELS, *WALL_KERNELS], **PAIRS)
    paths["cube"], one_card_mfp = run_cube_slice(
        tag, results["allpairs_partner"]["ms"])
    paths["sharded sweep"], sharded_pairs = run_sharded_slice(tag,
                                                              sweep_pairs)
    paths["sharded pairs"] = run_sharded_pairs_slice(tag, sharded_pairs)
    paths["sharded cube"] = run_sharded_cube(tag, one_card_mfp)
    # ``launches``: the path each kernel is the main one of.
    main_path = {**{k: "sweep" for k in KERNELS},
                 **{k: "pairs" for k in [*PAIRS_KERNELS, *WALL_KERNELS]},
                 **{k: "cube" for k in CUBE_KERNELS},
                 "pack_band_pair": "sharded sweep",
                 "pack_indices": "sharded pairs",
                 "specular_advance": "specular pairs"}
    check_specular_pore(tag)
    paths["specular pairs"] = check_specular_pore_pairs(tag)
    compare_cube_cells_with_allpairs(tag)
    check_cli(tag)
    breakdowns(tag)

    sources = {**KERNELS, **PAIRS_KERNELS, **WALL_KERNELS, **CUBE_KERNELS,
               **SHARD_KERNELS, **SPECULAR_KERNELS}
    require(set(results) == set(sources), "kernels line: entries missing")
    require(set(main_path) == set(sources), "kernels line: paths missing")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", **sources[name],
         "launches": paths[main_path[name]].get(name, 0), **r,
         "path_launches": {p: c.get(name, 0) for p, c in paths.items()}}
        for name, r in results.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
