"""Command-line entry point of the port (port of
``argon_monte_carlo_tpu.cli``): each workload is a subcommand with flags
for the common knobs, periodic checkpoints with exact resume, JSONL
metrics, and the reference-format artifacts written at the end.

    python -m argon_monte_carlo_tpu_torch.cli temperature_pore \\
        --steps 20000 --out runs/tp --checkpoint-every 2000

The run takes the card (``--device cuda``, the default) and nothing falls
back: without a card it stops with an error unless ``--device cpu`` asks
for the plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="argon_monte_carlo_tpu_torch",
        description="Hard-sphere argon Monte Carlo on a CUDA card "
                    "(PyTorch port)",
    )
    sub = p.add_subparsers(dest="workload", required=True)
    for name in ("cube", "pore", "temperature_pore"):
        w = sub.add_parser(name)
        w.add_argument("--steps", type=int, default=None,
                       help="timesteps (default: the workload's reference "
                            "count)")
        w.add_argument("--particles", type=int, default=None,
                       help="override the ideal-gas molecule count")
        w.add_argument("--target-particles", type=int, default=None,
                       help="scale the geometry to this molecule count at "
                            "ambient density (pore workloads)")
        w.add_argument("--seed", type=int, default=None)
        w.add_argument("--steps-per-mft", type=int, default=None,
                       help="timesteps per mean-free time (reference: "
                            "cube 25, pores 1000)")
        w.add_argument("--out", type=str, default=".",
                       help="output directory for artifacts")
        w.add_argument("--dtype", choices=["float32", "float64"],
                       default="float32",
                       help="float64 runs on --device cpu only (the "
                            "kernels take float32)")
        w.add_argument("--narrowphase", choices=["sweep", "pairs"],
                       default=None,
                       help="'pairs' = Verlet reach-pair list (sweep only "
                            "every --rebuild-interval steps).  Default: "
                            "pairs for the pore workloads, sweep for the "
                            "cube (whose per-step drift no top-k pair "
                            "budget covers)")
        w.add_argument("--rebuild-interval", type=int, default=None,
                       help="pair-list rebuild period K (narrowphase="
                            "pairs; default 8)")
        w.add_argument("--broadphase", choices=["cells", "allpairs"],
                       default=None)
        w.add_argument("--steps-per-epoch", type=int, default=100)
        w.add_argument("--checkpoint-every", type=int, default=0,
                       help="steps between checkpoints (0 = off)")
        w.add_argument("--resume", type=str, default=None,
                       help="checkpoint .npz to resume from")
        w.add_argument("--metrics", type=str, default=None,
                       help="JSONL metrics path (default: <out>/metrics.jsonl)")
        w.add_argument("--mesh", type=int, default=1,
                       help="z-slabs of the sharded engine (1 = one "
                            "Simulation; either narrow phase; the cube on "
                            "the cell grid); the slabs are dealt over the "
                            "visible cards")
        w.add_argument("--device", type=str, default="cuda",
                       help="'cuda' (default: the card; an error without "
                            "one) or 'cpu' (the plain versions)")
        w.add_argument("--quiet", action="store_true")
        w.add_argument("--plot", action="store_true",
                       help="save the 4-panel histogram figure "
                            "(histograms.png in --out; needs matplotlib)")
        w.add_argument("--debug-audits", action="store_true",
                       help="re-check wall-case predicates each step "
                            "(reference missed-case audit)")
        w.add_argument("--check-finite", action="store_true",
                       help="count non-finite state values each step")
    return p


def make_config(args):
    """The workload's config from parsed flags, with the reference CLI's
    defaults: pairs/K=8 for the pores, the sweep with the all-pairs broad
    phase for the cube (cli.py:88-126), on the cell grid where ``--mesh``
    cuts it into slabs."""
    from .config import CubeConfig, EngineConfig, PoreConfig

    narrowphase = getattr(args, "narrowphase", None)
    if narrowphase is None:
        narrowphase = "sweep" if args.workload == "cube" else "pairs"
    rebuild_interval = getattr(args, "rebuild_interval", None)
    if rebuild_interval is None:
        rebuild_interval = 8 if narrowphase == "pairs" else 1
    eng_kwargs = dict(dtype=args.dtype, steps_per_epoch=args.steps_per_epoch,
                      debug_audits=args.debug_audits,
                      check_finite=args.check_finite,
                      narrowphase=narrowphase,
                      rebuild_interval=rebuild_interval)
    if args.workload == "cube":
        sharded = getattr(args, "mesh", 1) > 1
        eng_kwargs["broadphase"] = args.broadphase or (
            "cells" if sharded else "allpairs")
        cfg = CubeConfig(
            num_particles_override=args.particles,
            engine=EngineConfig(**eng_kwargs),
        )
    else:
        eng_kwargs["broadphase"] = args.broadphase or "cells"
        cfg = PoreConfig(
            energized=(args.workload == "temperature_pore"),
            num_particles_override=args.particles,
            engine=EngineConfig(**eng_kwargs),
        )
        if args.target_particles:
            cfg = cfg.scaled_to(args.target_particles)
    if args.seed is not None:
        cfg = dataclasses.replace(cfg, seed=args.seed)
    if args.steps_per_mft is not None:
        cfg = dataclasses.replace(cfg, steps_per_mft=args.steps_per_mft)
    return cfg


def _refuse(message: str) -> int:
    print(f"error: {message}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from . import Simulation, kernels, make_workload
    from .io import checkpoint as ckpt_io
    from .io import metrics as metrics_io
    from .io import writers
    from .parallel import ShardedSimulation

    # Everything that can refuse the run does so before any work.
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        return _refuse("--device cuda, but no CUDA card is visible "
                       "(torch.cuda.is_available() is False); pass --device "
                       "cpu to run the plain versions on the CPU")
    kernels.require_float32(args.dtype, [device])
    if args.plot:
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            return _refuse("--plot needs matplotlib, which is not installed")
    cfg = make_config(args)
    sharded = args.mesh > 1
    if sharded and cfg.engine.broadphase != "cells":
        return _refuse(f"--mesh {args.mesh} cuts the cell grid into slabs: "
                       "drop --broadphase allpairs")

    os.makedirs(args.out, exist_ok=True)
    logger = metrics_io.MetricsLogger(
        args.metrics or os.path.join(args.out, "metrics.jsonl"),
        resume=bool(args.resume), device=device,
    )
    if sharded:
        sim = ShardedSimulation(
            make_workload(cfg), n_shards=args.mesh,
            devices=[device] if device.type == "cpu" else None)
    else:
        sim = Simulation(make_workload(cfg), device=device)
    num_steps = args.steps if args.steps is not None else cfg.num_timesteps

    if args.resume:
        if sharded:
            state, measure, gen, start_step = ckpt_io.load_sharded_checkpoint(
                args.resume, sim.devices)
            lanes = state[0][0].num_particles
            if lanes != sim.plan.shard_capacity:
                return _refuse(
                    f"{args.resume} holds {lanes} lanes a slab; this run's "
                    f"plan has {sim.plan.shard_capacity} (resume with the "
                    "same --mesh and workload)")
            window = ckpt_io.load_sharded_pair_window(args.resume,
                                                      sim.devices)
        else:
            state, measure, gen, start_step = ckpt_io.load_checkpoint(
                args.resume, device)
            window = ckpt_io.load_pair_window(args.resume, device)
        if window is not None:
            sim.resume_pair_window(state, *window)
        if not args.quiet:
            print(f"resumed from {args.resume} at step {start_step}")
            if ckpt_io.written_by_reference(args.resume):
                print("  the checkpoint holds no generator state (the JAX "
                      "package wrote it): the continuation draws from the "
                      "port's generator, seeded from its run_key and step, "
                      "not from the JAX run's keys")
    else:
        state, measure, gen = sim.init()
        start_step = 0
    gen_kw = {"generators" if sharded else "generator": gen}

    n = cfg.num_molecules
    if not args.quiet:
        print(f"{args.workload}: N={n} steps={num_steps} dt={cfg.dt:.4e} "
              f"broadphase={cfg.engine.broadphase} dtype={cfg.engine.dtype} "
              f"device={device}")

    all_momentum, all_ehot, all_ecold = [], [], []
    step = start_step
    next_ckpt = (
        step + args.checkpoint_every if args.checkpoint_every else None
    )
    t0 = time.time()
    while step < start_step + num_steps:
        chunk = min(cfg.engine.steps_per_epoch,
                    start_step + num_steps - step)
        if next_ckpt is not None:
            chunk = min(chunk, next_ckpt - step)
        state, measure, metrics = sim.run(
            num_steps=chunk, state=state, measure=measure, start_step=step,
            **gen_kw)
        host = metrics_io.epoch_to_host(metrics)
        record = logger.log_epoch(host, n, step)
        all_momentum.append(host["momentum_z"])
        all_ehot.append(host["energy_hot"])
        all_ecold.append(host["energy_cold"])
        step += chunk
        if not args.quiet:
            print(f"  step {step}/{start_step + num_steps}  "
                  f"collisions={record['collisions']}  "
                  f"{record['particle_steps_per_sec']:.3e} particle-steps/s")
        if next_ckpt is not None and step >= next_ckpt:
            path = os.path.join(args.out, f"checkpoint_{step:08d}.npz")
            if sharded:
                ckpt_io.save_sharded_checkpoint(path, state, measure, gen,
                                                step,
                                                pair_window=sim.pair_window())
            else:
                ckpt_io.save_checkpoint(path, state, measure, gen, step,
                                        pair_window=sim.pair_window())
            if not args.quiet:
                print(f"  checkpoint -> {path}")
            next_ckpt = step + args.checkpoint_every

    elapsed = time.time() - t0
    measure = sim.finalize_measure(measure)
    # Reference-format artifacts.
    writers.write_histograms(
        measure, cfg.engine.num_bins, cfg.engine.hist_range, args.out
    )
    if args.workload == "temperature_pore":
        writers.write_momentum_energy_csv(
            np.concatenate(all_momentum),
            np.concatenate(all_ecold),
            np.concatenate(all_ehot),
            os.path.join(args.out, "momentum_energy.csv"),
        )
    if args.plot:
        from . import plotting

        edges, dens = writers.histogram_densities(
            measure, cfg.engine.num_bins, cfg.engine.hist_range
        )
        fig = plotting.histogram_figure(
            edges, dens, fit=(args.workload == "cube"),
            title=args.workload,
        )
        fig.savefig(os.path.join(args.out, "histograms.png"), dpi=110,
                    bbox_inches="tight")
    if not args.quiet:
        from .analysis import path_statistics

        stats = path_statistics(
            measure, cfg.engine.num_bins, cfg.engine.hist_range
        )
        print(f"Simulation mean free path: {stats.mean_free_path:.6e}")
        print(f"Simulation mean x free path: {stats.mean_x_free_path:.6e}")
        print(f"Simulation mean y free path: {stats.mean_y_free_path:.6e}")
        print(f"Simulation mean z free path: {stats.mean_z_free_path:.6e}")
        print(f"Num of measured full paths total: "
              f"{stats.num_completed_paths}")
        if stats.num_completed_paths:
            print(f"exp fit: a={stats.exp_fit_a:.6e} "
                  f"b={stats.exp_fit_b:.6e} (-1/b = "
                  f"{stats.fitted_mfp:.6e} m)")
        print(f"total collisions: {int(measure.collision_count)}  "
              f"errs: {int(measure.err_count)}  "
              f"overflow: {int(measure.overflow_count)}")
        print(f"runtime: {elapsed/60.0:.2f} minutes  "
              f"({num_steps * n / max(elapsed, 1e-9):.3e} "
              f"particle-steps/sec)")
    logger.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
