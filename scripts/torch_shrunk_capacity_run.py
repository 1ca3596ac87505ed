#!/usr/bin/env python3
"""One benchmark run with the pairs engine's re-search capacity cut: a
fault that only ``dropped_per_million`` catches (the dirty lanes beyond the
capacity go unsearched a step and are counted in ``overflow_count``).
Its readings are the upper bound that a pairs cell's limit of
``dropped_per_million`` is set under.

    python3 scripts/torch_shrunk_capacity_run.py <divisor> <run.py args>

e.g. ``16 --workload tpore-10m.pairs --seed 1 --seconds 51 --trace 0``
runs the cell as ``bench_torch/run.py`` does, with
``research_capacity`` a sixteenth of what ``engine.pairs_config_for``
sizes.  The last line of standard output is the run's result.  Needs a
CUDA card, as the benchmark does.
"""

import dataclasses
import json
import sys
import time
from pathlib import Path

T0 = time.perf_counter()

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "bench_torch")]

import harness  # noqa: E402

from argon_monte_carlo_tpu_torch import engine  # noqa: E402


def main(argv) -> int:
    divisor, args = int(argv[0]), argv[1:]
    sized = engine.pairs_config_for

    def shrunk(workload, num_particles=None):
        pcfg = sized(workload, num_particles)
        return dataclasses.replace(
            pcfg, research_capacity=pcfg.research_capacity // divisor)

    engine.pairs_config_for = shrunk
    out = harness.run_cell(args, T0)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
