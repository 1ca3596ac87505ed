#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each prints its lines; any failed check raises and the script
exits non-zero without a result line):

0. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
1. build the four CUDA kernels from ``argon_monte_carlo_tpu_torch/kernels``;
2. each kernel against its plain PyTorch version on the same tensors on the
   card, at the shapes of the 1M-particle temperature pore, with both times;
3. the slice on the card against the slice on the CPU (the plain versions,
   which the CPU tests hold to the JAX package) at 20k particles, 10 steps,
   from one state with one set of uniforms;
4. the slice: ``Simulation(make_workload(cfg), device="cuda")`` for 300
   steps at 1M particles, float32, its invariants, throughput, init time and
   peak memory, with the launch count of every kernel in that run.

The last line is ``{"ok": true, "device": {...}}``.  There is no CPU path:
without CUDA the script stops before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import torch

import argon_monte_carlo_tpu_torch as amt
from argon_monte_carlo_tpu_torch import kernels
from argon_monte_carlo_tpu_torch.init import init_pore
from argon_monte_carlo_tpu_torch.ops import collide, measure as measure_ops
from argon_monte_carlo_tpu_torch.ops import oob
from argon_monte_carlo_tpu_torch.state import Measurements

PARTICLES = 1_000_000
STEPS = 300
STEPS_PER_EPOCH = 100
SEED = 17

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


def config(**engine):
    return amt.temperature_pore_config(
        engine=amt.EngineConfig(broadphase="cells", **engine)
    ).scaled_to(PARTICLES)


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


def check_against_cpu(tag: str) -> None:
    """The slice on the card against the same slice on the CPU -- the plain
    versions, which tests/test_torch_engine.py holds to the JAX reference
    -- from one initial state with one set of per-step uniforms, at a small
    size.  Counts and the histogram must be equal; the state may differ by
    the cos/sin rounding of the two devices (a few ulp a step)."""
    steps = 10
    cfg = amt.temperature_pore_config(
        engine=amt.EngineConfig(steps_per_epoch=5)).scaled_to(20_000)
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
              "oob_after_pairs"):
        exact(f"small run {f}", getattr(met_g, f).cpu(), getattr(met_c, f))
    for f in ("hist", "path_count", "collision_count", "err_count",
              "overflow_count", "hist_drop_count"):
        exact(f"small run {f}", getattr(m_g, f).cpu(), getattr(m_c, f))
    exact("small run has_collided", s_g.has_collided.cpu(), s_c.has_collided)
    rel = max(
        float((getattr(s_g, f).cpu() - getattr(s_c, f)).abs().max()
              / getattr(s_c, f).abs().max())
        for f in ("pos", "vel", "paths"))
    require(rel <= 1e-5, f"small run: state differs by {rel} relative")
    pairs = int((met_c.collisions - met_c.wall_hits).sum())
    require(pairs > 0, "small run: no pair collisions")
    print(f"small run vs CPU: N={state.num_particles} steps={steps} "
          f"pairs={pairs} wall_hits={int(met_c.wall_hits.sum())}: counts and "
          f"histogram equal, state max rel err {rel!r} (bound 1e-5) {tag}")


def run_slice(tag: str) -> dict:
    """Phase 3: the port's main path, counted."""
    cfg = config(steps_per_epoch=STEPS_PER_EPOCH)
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
    state, meas, metrics = sim.run(num_steps=STEPS, state=state,
                                   measure=meas, generator=gen,
                                   epoch_callback=on_epoch)
    torch.cuda.synchronize()
    counts = dict(kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated()

    # Invariants of the reference engine's temperature-pore test.
    finite = all(bool(torch.isfinite(t).all())
                 for t in (state.pos, state.vel, state.paths))
    require(finite, "slice: non-finite state")
    require(int(oob.pore_oob_count(state, cfg.geometry)) == 0,
            "slice: particles out of bounds")
    require(int(meas.err_count) == 0, "slice: wall-solver errors")
    pairs = int((metrics.collisions - metrics.wall_hits).sum())
    hits = int(metrics.wall_hits.sum())
    require(pairs > 0 and hits > 0, "slice: no collisions or wall hits")
    for f in ("momentum_z", "energy_hot", "energy_cold"):
        require(bool(torch.isfinite(getattr(metrics, f)).all()),
                f"slice: non-finite {f}")
    drop = int(meas.hist_drop_count)
    row_sums = meas.hist.sum(dim=1)
    require(bool((row_sums == int(meas.path_count) - drop).all()),
            "slice: histogram rows do not sum to path_count - drops")
    for name in KERNELS:
        require(counts.get(name, 0) > 0, f"slice: kernel {name} not launched")

    # Throughput over the synced epochs after the first.
    steady = (STEPS - STEPS_PER_EPOCH) / (marks[-1] - marks[0])
    first_epoch_s = marks[0] - t_run
    print(f"slice: N={n} steps={STEPS} pairs={pairs} wall_hits={hits} "
          f"path_count={int(meas.path_count)} hist_drop={drop} "
          f"overflow={int(meas.overflow_count)} err={int(meas.err_count)} "
          f"oob=0 finite=True {tag}")
    print(f"slice: particle-steps/s={steady * n!r} (epochs 2-{len(marks)}), "
          f"first epoch {first_epoch_s!r} s, init {init_s!r} s, "
          f"peak memory {peak / 2**30!r} GiB {tag}")
    print(f"slice: launches {counts} {tag}")
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
    check_against_cpu(tag)
    counts = run_slice(tag)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", **KERNELS[name],
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
