#!/usr/bin/env python3
"""Compare a full Temperature_Pore run of the PyTorch port's command line
with the JAX package's full run in the repository.

    python -m argon_monte_carlo_tpu_torch.cli temperature_pore \\
        --steps-per-epoch 200 --out RUN > RUN/cli.log
    python3 scripts/torch_full_run_compare.py RUN \\
        [runs/full_temperature_pore]

The port's run directory holds what the command line writes (the 8
histogram files, momentum_energy.csv, metrics.jsonl) and its printed
output in ``cli.log``; the reference directory holds the same files and
``report.json`` (scripts/full_reference_run.py).  Printed: the three
ledger series by chip_smoke's copy of the z-test of
scripts/parity_run.py:69-79, the collisions, completed paths and mean free
path with their relative differences (expected within 1%), the histograms'
correlations, and the run's wall time and particle-steps/s from its
metrics.  Exits 1 if a z-test or a 1% comparison fails.
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (its ledger z-test)
from argon_monte_carlo_tpu_torch.io import writers  # noqa: E402

TOLERANCE = 0.01
PATTERNS = {
    "collisions": r"total collisions: (\d+)",
    "completed_paths": r"Num of measured full paths total: (\d+)",
    "mean_free_path": r"Simulation mean free path: ([0-9.e+-]+)",
}


def main(argv) -> int:
    run = Path(argv[0])
    ref = Path(argv[1]) if len(argv) > 1 else (
        REPO / "runs" / "full_temperature_pore")
    ok = True
    ours = writers.read_momentum_energy_csv(str(run / "momentum_energy.csv"))
    theirs = writers.read_momentum_energy_csv(
        str(ref / "momentum_energy.csv"))
    print(f"ledger: {len(ours['index'])} steps against "
          f"{len(theirs['index'])}")
    for col, _ in chip_smoke.LEDGER_COLUMNS:
        z, ratio, passed = chip_smoke.ledger_z_test(theirs[col], ours[col])
        ok &= passed
        print(f"  {col}: mean {float(ours[col].mean())!r} against "
              f"{float(theirs[col].mean())!r}, z={z!r}, std ratio={ratio!r} "
              f"({'pass' if passed else 'FAIL'}: z < {chip_smoke.LEDGER_Z}, "
              f"ratio in {chip_smoke.LEDGER_STD_RATIO})")
    log = (run / "cli.log").read_text()
    report = json.loads((ref / "report.json").read_text())
    for key, pattern in PATTERNS.items():
        mine = float(re.findall(pattern, log)[-1])
        want = float(report[key])
        rel = (mine - want) / want
        within = abs(rel) <= TOLERANCE
        ok &= within
        print(f"{key}: {mine!r} against {want!r}, rel {rel!r} "
              f"({'within' if within else 'OUTSIDE'} {TOLERANCE:.0%})")
    for name in writers.AXIS_NAMES:
        a = writers.read_reference_histogram(
            str(run / f"hist_y_axis_{name}_data.txt"))
        b = writers.read_reference_histogram(
            str(ref / f"hist_y_axis_{name}_data.txt"))
        print(f"histogram {name}: correlation "
              f"{float(np.corrcoef(a, b)[0, 1])!r}, "
              f"L1 {float(np.abs(a - b).sum()) * 5e-9!r}")
    records = [json.loads(line) for line in
               (run / "metrics.jsonl").read_text().splitlines()]
    steps = sum(r["steps"] for r in records)
    print(f"metrics: {len(records)} epochs, {steps} steps, session "
          f"{records[-1]['session_particle_steps_per_sec']!r} "
          f"particle-steps/s over {records[-1]['elapsed_s']!r} s; "
          f"{re.findall(r'runtime: .*', log)[-1]}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
