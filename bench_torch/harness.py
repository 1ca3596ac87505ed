"""The benchmark of the PyTorch/CUDA port: one run of one cell.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) pairs a
configuration (``configs/<config>.json``: the deployment's numbers, read
by the program's constructors and by the plain reference alike) with a
traffic mix (``traffic/<traffic>.json``: the narrow phase, the rebuild
interval, the epoch, the flush and the audits); ``limits/<cell>.json``
holds the limits of the numbers that decide ``correct``; each per-layer
metric is ``metrics/<name>.py``.  A configuration's ``workload`` names its
kind: ``programs/<workload>.py`` builds the program's configuration of it
and ``reference/<workload>.py`` holds the reference's set-up, fill and
walls.  Nothing here names a cell or a kind.

A run: set-up (the kernel library, built on a checkout's first run; the
``Simulation``; ``init(seed)``; the first epoch, kept for the comparison,
which makes every kernel's first call and, in a pairs cell, a dozen
rebuilds), then whole epochs of
``Simulation.run(num_steps=steps_per_epoch, ...)`` each followed by
``io.metrics.epoch_to_host`` -- the command line's loop body without its
file writes -- for ``--seconds``; with ``--trace 1`` a traced slice
after that window.  Then the peak memory is read, the program freed, and
the reference run from the same seed.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

BENCH_DIR = Path(__file__).resolve().parent
GIB = float(2**30)


class CellError(ValueError):
    pass


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(bench: dict, workload: str, bench_dir: Path = BENCH_DIR) -> dict:
    """The files and metric entries of one cell, found by its names."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise CellError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    return dict(
        cell=cell,
        config=_load_json(bench_dir / "configs" / f"{cell['config']}.json"),
        traffic=_load_json(bench_dir / "traffic" / f"{cell['traffic']}.json"),
        limits=_load_json(bench_dir / "limits" / f"{workload}.json"),
        end_to_end=e2e,
        per_layer=[(m, load_module(bench_dir / "metrics" / f"{m['name']}.py",
                                   f"bench_metric_{m['name']}"))
                   for m in layer],
    )


def program_config(amt, cfg: dict, traffic: dict, bench_dir=BENCH_DIR):
    """The program's configuration from a configuration file and a mix,
    by ``programs/<workload>.py``."""
    hist = cfg["histogram"]
    eng = amt.EngineConfig(
        dtype=cfg["dtype"], broadphase=traffic["broadphase"],
        narrowphase=traffic["narrowphase"],
        rebuild_interval=traffic["rebuild_interval"],
        steps_per_epoch=traffic["steps_per_epoch"],
        hist_flush_interval=traffic["hist_flush_interval"],
        debug_audits=traffic["debug_audits"], num_bins=hist["num_bins"],
        hist_range=(0.0, hist["hi"]), **cfg["engine"])
    kind = load_module(bench_dir / "programs" / f"{cfg['workload']}.py",
                       f"bench_program_{cfg['workload']}")
    return kind.config(amt, cfg, eng)


def check_config(pcfg, cfg: dict, setup) -> None:
    """The program runs what the file states: its gas and its particle
    count are the reference's."""
    phys = pcfg.physics
    for key, value in cfg["gas"].items():
        if getattr(phys, key) != value:
            raise CellError(f"the program's gas has {key}="
                            f"{getattr(phys, key)!r}, the file {value!r}")
    if pcfg.num_molecules != setup.n:
        raise CellError(f"{pcfg.num_molecules} particles in the program, "
                        f"{setup.n} in the reference")
    if cfg.get("num_particles") not in (None, setup.n):
        raise CellError(f"the file states {cfg['num_particles']} particles,"
                        f" the run has {setup.n}")


def measure_window(run_epoch, seconds: float, clock=time.perf_counter,
                   marks=None):
    """Whole epochs until ``seconds`` have passed: (steps, seconds).  The
    window runs from the first epoch's start to the last one's return;
    ``marks``, a list, receives (elapsed, steps) after each epoch."""
    steps, start = 0, clock()
    while True:
        steps += run_epoch()
        elapsed = clock() - start
        if marks is not None:
            marks.append((elapsed, steps))
        if elapsed >= seconds:
            return steps, elapsed


def epoch_spread(marks) -> str:
    """The window's epochs: their seconds' quartiles and the rate of steps
    in each third of the window."""
    import statistics
    t = [0.0] + [m[0] for m in marks]
    n = [0] + [m[1] for m in marks]
    times = [b - a for a, b in zip(t, t[1:])]
    steps = [b - a for a, b in zip(n, n[1:])]
    q = (statistics.quantiles(times, n=4) if len(times) > 1
         else times * 3)
    thirds = [sum(steps[lo:hi]) / sum(times[lo:hi])
              for lo, hi in ((k * len(times) // 3,
                              (k + 1) * len(times) // 3) for k in range(3))
              if hi > lo]
    return (f"{len(times)} epochs, seconds first {times[0]:.4f}, "
            f"q1/median/q3 "
            f"{q[0]:.4f}/{q[1]:.4f}/{q[2]:.4f}, min {min(times):.4f}, max "
            f"{max(times):.4f}; steps/s by thirds "
            f"{[round(x, 1) for x in thirds]}")


def power_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not read"


def host_state(state, measure) -> dict:
    return dict(pos=state.pos.cpu(), vel=state.vel.cpu(),
                paths=state.paths.cpu(),
                has_collided=state.has_collided.cpu(),
                hist=measure.hist.cpu(), path_sum=measure.path_sum.cpu(),
                path_count=int(measure.path_count),
                hist_drop=int(measure.hist_drop_count))


def dropped(measure) -> int:
    """Particles dropped from full cells or from the collision search's
    capacity (``overflow_count``) and paths dropped from the histogram
    (``hist_drop_count``) so far: one copy from the card."""
    return int(torch.stack([measure.overflow_count,
                            measure.hist_drop_count]).sum())


def reference_reading(S, M, rows) -> dict:
    """The reference's run (``reference.step.run``) on the host, in the
    form ``correct.numbers`` compares."""
    return dict(pos=S["pos"].cpu(), vel=S["vel"].cpu(),
                paths=S["paths"].cpu(), has_collided=S["has_collided"].cpu(),
                hist=M["hist"].cpu(), path_sum=M["path_sum"].cpu(),
                path_count=M["path_count"], rows=rows)


def ledger_rows(host: dict) -> list:
    return [[float(a), float(b), float(c), int(d)] for a, b, c, d in zip(
        host["momentum_z"], host["energy_hot"], host["energy_cold"],
        host["collisions"])]


class Run:
    """The program under test, built for one cell and seed."""

    def __init__(self, amt, metrics_io, cfg, traffic, seed, device,
                 spans=None, span_names=(), bench_dir=BENCH_DIR):
        self.io = metrics_io
        self.pcfg = program_config(amt, cfg, traffic, bench_dir)
        workload = amt.make_workload(self.pcfg)
        if spans is not None:
            workload = spans.on_workload(workload, span_names)
            spans.on_modules(span_names)
        self.sim = amt.Simulation(workload, device=device)
        if spans is not None:
            spans.on_simulation(self.sim, span_names)
        self.spe = traffic["steps_per_epoch"]
        self.state, self.measure, self.gen = self.sim.init(seed)
        self.step = 0
        self.bad_steps = 0

    def steps(self, k: int) -> dict:
        """``k`` steps through the timed entry and the epoch boundary."""
        self.state, self.measure, metrics = self.sim.run(
            num_steps=k, state=self.state, measure=self.measure,
            generator=self.gen, start_step=self.step)
        host = self.io.epoch_to_host(metrics)
        self.step += k
        ledger = [host[f] for f in ("momentum_z", "energy_hot",
                                    "energy_cold")]
        self.bad_steps += int(sum(
            1 for i in range(k)
            if not all(math.isfinite(float(v[i])) for v in ledger)
            or host["collisions"][i] < 0))
        return host

    def epoch(self) -> int:
        self.steps(self.spe)
        return self.spe

    def compared_epoch(self) -> dict:
        """The first epoch, kept for ``correct``: the state and the
        accumulators after it, on the host, and its ledger rows."""
        head = self.steps(self.spe)
        prog = host_state(self.state, self.measure)
        prog["rows"] = ledger_rows(head)
        return prog


def run_cell(argv, t0: float, device: str = "cuda", bench_dir=BENCH_DIR,
             log=sys.stderr) -> dict:
    """One run; returns the result line's object (``checked`` last)."""
    p = argparse.ArgumentParser(prog="bench_torch/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = _load_json(bench_dir.parent / "BENCHMARK.json")
    cell = resolve(bench, args.workload, bench_dir)
    cfg, traffic = cell["config"], cell["traffic"]
    sys.path.insert(0, str(bench_dir))
    from reference import model, step as ref_step
    import correct
    import profiling as tr
    import argon_monte_carlo_tpu_torch as amt
    from argon_monte_carlo_tpu_torch import kernels
    from argon_monte_carlo_tpu_torch.io import metrics as metrics_io

    setup = model.setup_from(cfg)
    on_card = device == "cuda"
    phases = [("imports", time.perf_counter())]
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        kernels.library()
    phases.append(("library", time.perf_counter()))
    spans, span_names = None, []
    if args.trace:
        spans = tr.Spans()
        span_names = sorted({s for _, mod in cell["per_layer"]
                             for s in getattr(mod, "SPANS", ())})
    run = Run(amt, metrics_io, cfg, traffic, args.seed, device, spans,
              span_names, bench_dir)
    check_config(run.pcfg, cfg, setup)
    n = run.state.num_particles
    phases.append(("Simulation and init", time.perf_counter()))

    # The compared epoch, through the timed entry: the warm-up too.
    check_steps = run.spe
    prog = run.compared_epoch()
    dropped_before = dropped(run.measure)
    if on_card:
        torch.cuda.synchronize()
    # Set-up's objects out of the collector's way; the window's own
    # garbage is still collected.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0
    phases.append(("compared epoch", t0 + setup_s))
    print("set-up: " + ", ".join(
        f"{name} {b - a:.3f} s" for (name, b), a in zip(
            phases, [t0] + [p[1] for p in phases])), file=log)

    marks = []
    steps, window_s = measure_window(run.epoch, args.seconds, marks=marks)
    print(f"window: {epoch_spread(marks)}", file=log)
    result_metrics, device_extra, breakdown, traced = {}, {}, None, None
    if args.trace:
        traced_epochs = (math.lcm(run.spe, traffic["rebuild_interval"])
                         // run.spe)
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        spans.active = True
        with profile(activities=activities) as prof:
            t_slice = time.perf_counter()
            traced_steps = sum(run.epoch() for _ in range(traced_epochs))
            if on_card:
                torch.cuda.synchronize()
            slice_s = time.perf_counter() - t_slice
        spans.active = False
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    gc.unfreeze()
    # Every step of the run, those whose ledger is not finite; the steps
    # after the compared epoch are also held to what they dropped.
    attempted, failed = run.step, run.bad_steps
    later = run.step - check_steps
    dropped_per_million = 1e6 * (dropped(run.measure) - dropped_before) / (
        n * later)
    if args.trace:
        red = tr.reduce(prof, set(spans.names))
        del prof
        traced = tr.Traced(
            events=red["events"], calls=red["calls"], steps=traced_steps,
            busy_s=red["busy_s"], window_s=slice_s,
            untraced_step_s=window_s / steps, state=run.state, sim=run.sim,
            setup=setup, traffic=traffic, seed=args.seed)
        for entry, mod in cell["per_layer"]:
            value = mod.read(traced)
            if value is not None:
                result_metrics[entry["name"]] = {"value": value,
                                                 "unit": entry["unit"]}
        breakdown = tr.breakdown(red)
        device_extra = {"busy_s": red["busy_s"], "window_s": slice_s}
        print(f"traced: {traced_steps} steps in {slice_s!r} s, device busy "
              f"{red['busy_s']!r} s, {len(red['events'])} device events "
              f"({red['unmatched']} not matched to a launch), span calls "
              f"{red['calls']}", file=log)
    else:
        values = {"particle_steps_per_s": n * steps / window_s,
                  "peak_mem_gib": peak / GIB, "setup_s": setup_s}
        for entry in cell["end_to_end"]:
            result_metrics[entry["name"]] = {"value": values[entry["name"]],
                                             "unit": entry["unit"]}
    print(f"{args.workload}: N={n} seed={args.seed} window {steps} steps in "
          f"{window_s!r} s, set-up {setup_s!r} s, peak {peak} B; "
          f"card {power_line() if on_card else 'none (cpu)'}", file=log)

    # The program freed, the reference from the same seed.
    del run
    traced = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_reading(*ref_step.run(setup, args.seed, check_steps,
                                          device))
    rows = ref["rows"]
    values = correct.numbers(prog, ref, setup)
    values["dropped_per_million"] = dropped_per_million
    ok, checked = correct.judge(values, cell["limits"]["numbers"])
    drop = checked.get("dropped_per_million")
    if drop is not None and not dropped_per_million <= drop["limit"]:
        failed += later
    print(f"reference: {check_steps} steps in "
          f"{time.perf_counter() - t_ref!r} s; collisions and wall hits "
          f"{sum(r[3] for r in rows)}, {ref['path_count']} paths; program "
          f"{sum(r[3] for r in prog['rows'])}, {prog['path_count']} paths, "
          f"{prog['hist_drop']} dropped from the histogram; all numbers "
          f"{values}", file=log)

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": peak, **device_extra}
    out = {"correct": ok and failed == 0, "attempted": attempted,
           "failed": failed, "metrics": result_metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checked"] = checked
    for name, c in checked.items():
        print(f"checked {name}: {c['value']!r} (limit {c['limit']!r})",
              file=log)
    return out
