#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from.

    python3 bench_torch/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6]

For each seed of ``--seeds``: the program's first epoch through the timed
entry (as ``run.py`` takes it) against the plain reference's, the numbers
of ``correct.numbers``.  For each of ``--control-seeds``: the control --
the reference itself in the nearest precision below the configuration's
(bfloat16 for float32), from the same draws -- against the reference.
One JSON line a reading; then, per number, the largest program reading
and the smallest control reading.  Needs a CUDA card, as the runs do.
"""

import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH.parent))
sys.path.insert(0, str(BENCH))

import torch  # noqa: E402

import correct  # noqa: E402
import harness  # noqa: E402
from reference import model, step as ref_step  # noqa: E402

CONTROL_DTYPE = {"float32": torch.bfloat16, "float64": torch.float32}


def readings(workload, seeds, control_seeds, device="cuda",
             bench_dir=BENCH, emit=print):
    """Yield (kind, seed, numbers) for the program's and the control's
    seeds."""
    import argon_monte_carlo_tpu_torch as amt
    from argon_monte_carlo_tpu_torch.io import metrics as metrics_io

    bench = harness._load_json(bench_dir.parent / "BENCHMARK.json")
    cell = harness.resolve(bench, workload, bench_dir)
    cfg, traffic = cell["config"], cell["traffic"]
    setup = model.setup_from(cfg)
    out = []
    for seed in seeds:
        run = harness.Run(amt, metrics_io, cfg, traffic, seed, device)
        harness.check_config(run.pcfg, cfg, setup)
        prog = run.compared_epoch()
        del run
        t = time.perf_counter()
        ref = harness.reference_reading(*ref_step.run(setup, seed, traffic[
            "steps_per_epoch"], device))
        ref_s = time.perf_counter() - t
        values = correct.numbers(prog, ref, setup)
        emit(json.dumps({"kind": "program", "seed": seed, **values,
                         "reference_s": ref_s,
                         "paths": ref["path_count"],
                         "events": sum(r[3] for r in ref["rows"]),
                         "hist_drop": prog["hist_drop"]}))
        out.append(("program", seed, values))
    low = CONTROL_DTYPE[cfg["dtype"]]
    for seed in control_seeds:
        steps = traffic["steps_per_epoch"]
        ref = harness.reference_reading(*ref_step.run(setup, seed, steps,
                                                      device))
        ctl = harness.reference_reading(*ref_step.run(setup, seed, steps,
                                                      device, low))
        values = correct.numbers(ctl, ref, setup)
        emit(json.dumps({"kind": "control", "seed": seed,
                         "dtype": str(low), **values}))
        out.append(("control", seed, values))
    return out


def main(argv) -> int:
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 3
    seeds = [int(s) for s in a.seeds.split(",") if s]
    controls = [int(s) for s in a.control_seeds.split(",") if s]
    out = readings(a.workload, seeds, controls)
    summary = {}
    for kind, _, values in out:
        for name, v in values.items():
            s = summary.setdefault(name, {})
            if kind == "program":
                s["program_max"] = max(s.get("program_max", v), v)
            else:
                s["control_min"] = min(s.get("control_min", v), v)
    print(json.dumps({"workload": a.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
