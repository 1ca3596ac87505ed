#!/usr/bin/env python3
"""The control of a cell's ``correct`` over the first steps of its compared
epoch: the plain reference in the nearest precision below the
configuration's (bfloat16 for float32), from the same draws, against the
reference, on the numbers of ``bench_torch/correct.py`` --
``bench_torch/calibrate.py``'s control, cut to ``steps`` steps where the
whole epoch of the low-precision reference does not finish in a call (at
10M molecules the bfloat16 reference's first seed ran past 900 s of an
H100's time, where the float32 reference takes ~30 s).

    python3 scripts/torch_short_control.py --workload <cell> --steps 10 \
        --seeds 1,2,3

One JSON line a seed (the numbers and both references' seconds); then,
per number, the smallest reading.  On the card unless ``--device cpu``.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent / "bench_torch"
sys.path[:0] = [str(BENCH.parent), str(BENCH)]

import torch  # noqa: E402

import calibrate  # noqa: E402
import correct  # noqa: E402
import harness  # noqa: E402
from reference import model, step as ref_step  # noqa: E402


def main(argv) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--steps", type=int, required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        print("short control: needs a CUDA card", file=sys.stderr)
        return 3
    bench = harness._load_json(BENCH.parent / "BENCHMARK.json")
    cfg = harness.resolve(bench, a.workload)["config"]
    setup = model.setup_from(cfg)
    low = calibrate.CONTROL_DTYPE[cfg["dtype"]]
    smallest = {}
    for seed in (int(s) for s in a.seeds.split(",")):
        t = time.perf_counter()
        ref = harness.reference_reading(*ref_step.run(setup, seed, a.steps,
                                                      a.device))
        t_ref = time.perf_counter() - t
        ctl = harness.reference_reading(*ref_step.run(setup, seed, a.steps,
                                                      a.device, low))
        values = correct.numbers(ctl, ref, setup)
        print(json.dumps({"kind": "control", "seed": seed,
                          "steps": a.steps, "dtype": str(low), **values,
                          "reference_s": t_ref,
                          "control_s": time.perf_counter() - t - t_ref}),
              flush=True)
        for name, v in values.items():
            smallest[name] = min(smallest.get(name, v), v)
    print(json.dumps({"workload": a.workload, "steps": a.steps,
                      "control_min": smallest}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
