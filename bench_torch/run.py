#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port on NVIDIA cards.

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cells, their metrics and bounds are in
``BENCHMARK.json``; ``bench_torch/harness.py`` says what a run does.  The
last line of standard output is the result as one JSON object; the numbers
that decide ``correct`` are also the last lines of standard error, each
beside its limit.  Without a CUDA card, or with fewer cards than the cell
asks for, the run prints no result and exits with code 3.
"""

import time

T0 = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Every build and kernel cache at a fixed place inside the checkout.
CACHE = BENCH / ".cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(BENCH))

import torch  # noqa: E402

import harness  # noqa: E402


def chips_asked(argv) -> int:
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    name = argv[argv.index("--workload") + 1] if "--workload" in argv else None
    for w in bench["workloads"]:
        if w["name"] == name:
            return int(w["chips"])
    raise harness.CellError(f"no workload {name!r} in BENCHMARK.json")


def main(argv) -> int:
    chips = chips_asked(argv)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_torch: needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" visible", file=sys.stderr)
        return 3
    out = harness.run_cell(argv, T0)
    sys.stdout.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
