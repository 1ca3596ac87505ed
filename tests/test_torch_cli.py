"""The port's command line end to end (subprocess, ``--device cpu``, real
files), the port of tests/test_cli.py, plus its refusals.

Checked: the files a run writes; that a run resumed from a checkpoint
writes a final checkpoint bitwise equal to the uninterrupted run's; the
workload defaults and that ``make_config`` equals the JAX CLI's field by
field for the same arguments; ``--mesh``, ``--debug-audits`` and
``--plot``; and that nothing falls back to the CPU unasked.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from argon_monte_carlo_tpu import cli as jcli
from argon_monte_carlo_tpu_torch import cli as tcli

REPO = Path(__file__).resolve().parent.parent
CHECKED = ("pos", "vel", "paths", "has_collided", "hist", "path_sum",
           "path_count", "collision_count")


def run_cli(args, tmp_path, device="cpu"):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    argv = list(args) + (["--device", device] if device else [])
    return subprocess.run(
        [sys.executable, "-m", "argon_monte_carlo_tpu_torch.cli"] + argv,
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=600,
    )


def test_temperature_pore_cli_and_exact_resume(tmp_path):
    out, again = tmp_path / "run", tmp_path / "again"
    common = ["--particles", "2000", "--steps-per-epoch", "6",
              "--checkpoint-every", "6"]
    r = run_cli(["temperature_pore", "--steps", "12", "--out", str(out)]
                + common, tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    files = os.listdir(out)
    for name in ("momentum_energy.csv", "metrics.jsonl",
                 "hist_x_axis_total_data.txt", "hist_y_axis_z_data.txt",
                 "checkpoint_00000006.npz", "checkpoint_00000012.npz"):
        assert name in files, (name, files)
    with open(out / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["steps"] for r in records] == [6, 6]
    assert "device_memory" not in records[0]     # none on the CPU
    assert "Simulation mean free path" in r.stdout
    assert (out / "momentum_energy.csv").read_text().count("\n") == 13

    # Resume from step 6 for 6 more steps into another directory.
    r2 = run_cli(["temperature_pore", "--steps", "6", "--out", str(again),
                  "--resume", str(out / "checkpoint_00000006.npz")] + common,
                 tmp_path)
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "resumed" in r2.stdout
    with np.load(out / "checkpoint_00000012.npz") as a, \
            np.load(again / "checkpoint_00000012.npz") as b:
        for f in CHECKED:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
        assert int(a["step"]) == int(b["step"]) == 12
        # The pairs run's list and window travel with the state.
        assert int(a["pairs_window_left"]) == int(b["pairs_window_left"])
    whole = (out / "momentum_energy.csv").read_text().splitlines()
    tail = (again / "momentum_energy.csv").read_text().splitlines()
    assert [line.split(",", 1)[1] for line in whole[7:]] == [
        line.split(",", 1)[1] for line in tail[1:]]


@pytest.mark.skipif(importlib.util.find_spec("matplotlib") is None,
                    reason="matplotlib is not installed")
def test_cube_cli_with_plot(tmp_path):
    out = tmp_path / "cube"
    r = run_cli(["cube", "--steps", "10", "--particles", "1500",
                 "--steps-per-epoch", "5", "--out", str(out), "--plot"],
                tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert (out / "histograms.png").stat().st_size > 10_000
    assert "mean free path" in r.stdout
    assert not (out / "momentum_energy.csv").exists()


def test_default_engine_is_flagship_pairs():
    """pairs/K=8 for the pores, the sweep with all pairs for the cube;
    explicit flags still win; --device defaults to the card."""
    p = tcli.build_parser()
    for workload, narrow, k, broad in (
            ("temperature_pore", "pairs", 8, "cells"),
            ("pore", "pairs", 8, "cells"),
            ("cube", "sweep", 1, "allpairs")):
        args = p.parse_args([workload])
        assert args.device == "cuda"
        cfg = tcli.make_config(args)
        assert cfg.engine.narrowphase == narrow, workload
        assert cfg.engine.rebuild_interval == k, workload
        assert cfg.engine.broadphase == broad, workload
    cfg = tcli.make_config(p.parse_args(["temperature_pore", "--narrowphase",
                                         "sweep"]))
    assert (cfg.engine.narrowphase, cfg.engine.rebuild_interval) == (
        "sweep", 1)


@pytest.mark.parametrize("argv", [
    ["temperature_pore"],
    ["pore", "--narrowphase", "sweep", "--target-particles", "50000",
     "--seed", "3"],
    ["temperature_pore", "--rebuild-interval", "4", "--steps-per-mft",
     "500", "--debug-audits", "--check-finite", "--dtype", "float64"],
    ["cube", "--broadphase", "cells", "--particles", "3000",
     "--steps-per-epoch", "7"],
])
def test_make_config_equals_reference(argv):
    """Every field both packages' configs have, for the same arguments."""
    want = jcli.make_config(jcli.build_parser().parse_args(argv))
    got = tcli.make_config(tcli.build_parser().parse_args(argv))
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(got):
        if f.name == "engine":
            continue
        a, b = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name
    for f in dataclasses.fields(got.engine):
        assert getattr(got.engine, f.name) == getattr(want.engine,
                                                      f.name), f.name
    assert got.num_molecules == want.num_molecules
    assert (got.num_timesteps, got.dt) == (want.num_timesteps, want.dt)


def test_mesh_runs_the_sharded_sweep(tmp_path):
    out = tmp_path / "mesh"
    argv = ["temperature_pore", "--mesh", "2", "--narrowphase", "sweep",
            "--target-particles", "3000"]
    n = tcli.make_config(tcli.build_parser().parse_args(argv)).num_molecules
    r = run_cli(argv + ["--steps", "6", "--steps-per-epoch", "3",
                        "--checkpoint-every", "3", "--out", str(out)],
                tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    with np.load(out / "checkpoint_00000006.npz") as z:
        assert bool(z["sharded"]) and z["generator_state"].shape[0] == 2
        assert int(z["valid"].sum()) == n
    r2 = run_cli(["temperature_pore", "--mesh", "2", "--narrowphase", "sweep",
                  "--target-particles", "3000", "--steps", "3",
                  "--steps-per-epoch", "3", "--out", str(tmp_path / "m2"),
                  "--resume", str(out / "checkpoint_00000003.npz")],
                 tmp_path)
    assert r2.returncode == 0, r2.stderr[-2000:]
    # The pores' default narrow phase (pairs) waits for the sharded pairs
    # mode: refused before any work, naming the flag that runs.
    r3 = run_cli(["temperature_pore", "--mesh", "2", "--out",
                  str(tmp_path / "m3")], tmp_path)
    assert r3.returncode != 0
    assert "--narrowphase sweep" in r3.stderr
    assert not (tmp_path / "m3").exists()


def test_debug_audits(tmp_path):
    out = tmp_path / "audit"
    r = run_cli(["temperature_pore", "--debug-audits", "--target-particles",
                 "3000", "--steps", "6", "--steps-per-epoch", "3",
                 "--out", str(out)], tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "total collisions" in r.stdout


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a CUDA card is visible: the run would take it")
def test_no_card_and_no_cpu_flag_exits_non_zero(tmp_path):
    out = tmp_path / "nocard"
    r = run_cli(["temperature_pore", "--steps", "2", "--particles", "500",
                 "--out", str(out)], tmp_path, device=None)
    assert r.returncode != 0
    assert "--device cpu" in r.stderr
    assert not out.exists()


def test_float64_on_the_card_and_plot_refused_before_the_run(tmp_path):
    r = run_cli(["temperature_pore", "--dtype", "float64", "--out",
                 str(tmp_path / "f64")], tmp_path, device="cuda")
    assert r.returncode != 0
    if torch.cuda.is_available():
        assert "ValueError" in r.stderr and "float32" in r.stderr
    # --plot where matplotlib cannot be imported.
    env = dict(os.environ, PYTHONPATH=str(REPO))
    code = ("import sys; sys.modules['matplotlib'] = None; "
            "from argon_monte_carlo_tpu_torch import cli; "
            "sys.exit(cli.main(['cube', '--plot', '--device', 'cpu', "
            f"'--out', {str(tmp_path / 'plot')!r}]))")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "matplotlib" in r.stderr
    assert not (tmp_path / "plot").exists()
