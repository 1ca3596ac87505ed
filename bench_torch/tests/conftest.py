"""The benchmark's own CPU tests (``python -m pytest bench_torch/tests``):
the harness, its counts and its comparison at small sizes, with the
program's plain versions standing in for its kernels."""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# Sizes a CPU holds: the pore scaled to ~3,000 molecules, 2,000 in the box.
SMALL = {"tpore-1m": {"target_particles": 3000, "num_particles": None},
         "cube": {"num_particles": 2000}}


@pytest.fixture
def small_bench(tmp_path):
    """A copy of the benchmark (``BENCHMARK.json`` and ``bench_torch/``)
    with every configuration cut to a CPU's size; returns its
    ``bench_torch`` directory."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "bench_torch",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for name, change in SMALL.items():
        path = root / "bench_torch" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        for k, v in change.items():
            if v is None:
                cfg.pop(k, None)
            else:
                cfg[k] = v
        path.write_text(json.dumps(cfg))
    return root / "bench_torch"
