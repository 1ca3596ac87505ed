"""The specular pore at 1M molecules (``bench_torch/configs/spore-1m.json``,
the cell ``spore-1m.pairs``) on the CPU: the file shares the energized
pore's geometry, histogram and engine and the cube's gas; the program and
the benchmark's plain reference agree on the count, the gas, and through
the file cut to ~1,500 particles for one 100-step epoch of the pairs path
at the cell's limits, where a planted wall fault reads false; the
reference imports neither JAX nor the port; a profiled run records
``amc/step/walls`` once a step; the three readers of that span return
numbers on a trace that holds it and None on one that does not (a K8 run
on the card, or a program without the span); the count of the pass's job
(``counts/walls.py``) on a planted state.  Imports no JAX."""

import importlib.util
import json
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import argon_monte_carlo_tpu_torch as amt
from argon_monte_carlo_tpu_torch.models import pore as pore_model
from argon_monte_carlo_tpu_torch.ops import pore_pass
from argon_monte_carlo_tpu_torch.ops import walls as wall_ops

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench_torch"
CELL = "spore-1m.pairs"
SMALL = 1500
SHARED = ("dtype", "nmft", "steps_per_mft", "num_timesteps", "reduced",
          "target_particles", "num_particles", "geometry", "histogram",
          "engine")
READERS = ("walls_ms_per_step", "walls_ops_per_step", "walls_roofline_pct")


def load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def config(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


@pytest.fixture(scope="module")
def harness():
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    return load(BENCH / "harness.py", "bench_harness_spore")


@pytest.mark.parametrize("key", SHARED)
def test_the_file_shares_the_energized_pores_blocks(key):
    assert config("spore-1m")[key] == config("tpore-1m")[key]


def test_the_gas_is_the_cubes_and_there_is_no_thermal_block():
    cfg = config("spore-1m")
    assert cfg["gas"] == config("cube")["gas"]
    assert cfg["gas"]["boltzmann"] == 1.38e-23
    assert (cfg["name"], cfg["workload"]) == ("spore-1m", "specular_pore")
    assert "thermal" not in cfg and len(cfg["source"]) <= 200


def test_the_program_runs_what_the_file_states(harness):
    cfg = config("spore-1m")
    traffic = json.loads((BENCH / "traffic" / "pairs.json").read_text())
    pcfg = harness.program_config(amt, cfg, traffic)
    from reference import model
    setup = model.setup_from(cfg)
    harness.check_config(pcfg, cfg, setup)
    assert not pcfg.energized and pcfg.physics == amt.PoreConfig().physics
    assert pcfg.num_molecules == setup.n == cfg["num_particles"] == 999_999
    assert pcfg.dt == setup.dt == pytest.approx(1.848e-13, rel=1e-3)
    wl = amt.make_workload(pcfg)
    assert wl.post_pairs_stage is None and wl.advance is not wl.advance_plain
    assert any(isinstance(c.cell_contents, pore_pass.SpecularParams)
               for c in wl.advance.__closure__)


@pytest.fixture
def small_bench(tmp_path):
    """The benchmark with ``spore-1m`` cut to ~1,500 molecules."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "bench_torch",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    path = root / "bench_torch" / "configs" / "spore-1m.json"
    cfg = json.loads(path.read_text())
    cfg["target_particles"] = SMALL
    del cfg["num_particles"]
    path.write_text(json.dumps(cfg))
    return root / "bench_torch"


def run_cell(harness, small_bench):
    return harness.run_cell(
        ["--workload", CELL, "--seed", "2718281828", "--seconds", "0.1",
         "--trace", "0"], time.perf_counter(), device="cpu",
        bench_dir=small_bench)


def test_port_and_reference_agree_cut_small(harness, small_bench):
    out = run_cell(harness, small_bench)
    assert out["correct"] is True and out["failed"] == 0, out["checked"]
    assert set(out["checked"]) == {"lanes_off_pct", "events_gap",
                                   "hist_gap", "dropped_per_million"}


def compared_epoch(harness, small_bench):
    """What decides ``correct`` for the first epoch alone, as the run takes
    it (no window after it): (correct, the numbers against their
    limits)."""
    import correct
    from reference import model, step as ref_step
    bench = json.loads((small_bench.parent / "BENCHMARK.json").read_text())
    cell = harness.resolve(bench, CELL, small_bench)
    cfg, traffic = cell["config"], cell["traffic"]
    from argon_monte_carlo_tpu_torch.io import metrics as metrics_io
    run = harness.Run(amt, metrics_io, cfg, traffic, 2718281828, "cpu")
    setup = model.setup_from(cfg)
    prog = run.compared_epoch()
    ref = harness.reference_reading(*ref_step.run(
        setup, 2718281828, traffic["steps_per_epoch"], "cpu"))
    values = dict(correct.numbers(prog, ref, setup), dropped_per_million=0.0)
    return correct.judge(values, cell["limits"]["numbers"])


def paths_left_running(state, measure, event, case_mask, *_args, **_kw):
    """``apply_tracked`` that counts the hits but ends no path."""
    return state, measure, torch.sum(case_mask, dtype=torch.int32)


def side_walls_skipped(state, mask, radius):
    """``specular_cylinder`` that handles no lane."""
    zero = torch.zeros((), dtype=state.pos.dtype, device=state.pos.device)
    none = torch.zeros_like(mask)
    return wall_ops.WallEvent(state, none, torch.zeros_like(state.pos[:, 0]),
                              state.vel, none, zero, zero)


@pytest.mark.parametrize("fault", ["paths left running",
                                   "side walls skipped"])
def test_a_planted_wall_fault_is_not_correct(harness, small_bench,
                                             monkeypatch, fault):
    if fault == "paths left running":
        monkeypatch.setattr(pore_model, "apply_tracked", paths_left_running)
    else:
        monkeypatch.setattr(wall_ops, "specular_cylinder",
                            side_walls_skipped)
    assert compared_epoch(harness, small_bench)[0] is False


def test_the_reference_imports_neither_jax_nor_the_port():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(BENCH)!r})\n"
        "import reference.specular_pore, reference.step, reference.model\n"
        "from reference import model\n"
        "model.kind('specular_pore')\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', "
        "'argon_monte_carlo_tpu', 'argon_monte_carlo_tpu_torch'}))\n")
    got = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=BENCH)
    assert got.returncode == 0, got.stderr
    assert got.stdout.strip().splitlines()[-1] == "[]"


def test_a_profiled_run_records_the_walls_span_once_a_step():
    steps = 4
    cfg = amt.PoreConfig(engine=amt.EngineConfig(
        narrowphase="pairs", rebuild_interval=8,
        steps_per_epoch=steps)).scaled_to(SMALL)
    sim = amt.Simulation(amt.make_workload(cfg), device="cpu")
    state, measure, gen = sim.init(5)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sim.run(num_steps=steps, state=state, measure=measure, generator=gen)
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name.startswith("amc/step/")]
    walls = [(a, b) for n, a, b in spans if n == "amc/step/walls"]
    advance = [(a, b) for n, a, b in spans if n == "amc/step/advance"]
    assert len(walls) == len(advance) == steps
    assert all(a0 <= a and b <= b0 for (a, b), (a0, b0) in zip(walls,
                                                                advance))


CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def event(name, start, end, device=CPU, id=0):
    return types.SimpleNamespace(
        name=name, device_type=device, id=id, thread=1,
        linked_correlation_id=0,
        time_range=types.SimpleNamespace(start=start, end=end))


def fake_profile(with_walls: bool):
    """Two steps: in each a plain pass of two elementwise ops inside
    ``amc/step/walls`` (20 us of device time) and one kernel after it."""
    events = [event("amc/epoch", 0.0, 400.0)]
    for k, t0 in enumerate((0.0, 200.0)):
        events += [event("amc/step", t0 + 1.0, t0 + 190.0),
                   event("amc/step/advance", t0 + 2.0, t0 + 100.0)]
        if with_walls:
            events.append(event("amc/step/walls", t0 + 3.0, t0 + 90.0))
        for j, (launch, start, end) in enumerate((
                (t0 + 10.0, t0 + 20.0, t0 + 30.0),
                (t0 + 40.0, t0 + 50.0, t0 + 60.0),
                (t0 + 120.0, t0 + 130.0, t0 + 170.0))):
            cid = 10 * k + j + 1
            events += [event("cudaLaunchKernel", launch, launch + 1.0,
                             id=cid),
                       event("elementwise_kernel", start, end, CUDA,
                             id=cid)]
    return types.SimpleNamespace(events=lambda: events)


def small_setup():
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    from reference import model
    return model.setup_from(config("spore-1m"))


def planted_state(setup):
    """Five particles: one in no case, one beyond the open air's side
    (case 1), one below the bottom cap and one above the top cap (case
    2), one that crosses the cold annular face in the step (case 3)."""
    g = setup.geometry
    h, oah, r_oa = g.total_height, g.open_air_height, g.open_air_radius
    pos = torch.tensor([
        [0.0, 0.0, 0.5 * h],
        [1.01 * r_oa, 0.0, 0.5 * oah],
        [0.0, 0.0, -1e-10],
        [0.0, 0.0, h + 1e-10],
        [2.0 * g.pore_coated_radius, 0.0, h - oah + 2e-11],
    ], dtype=torch.float32)
    vel = torch.tensor([[100.0, 0.0, 0.0], [300.0, 0.0, 0.0],
                        [0.0, 0.0, -300.0], [0.0, 0.0, 300.0],
                        [0.0, 0.0, -500.0]], dtype=torch.float32)
    return types.SimpleNamespace(
        pos=pos, vel=vel, paths=torch.zeros((5, 4)),
        has_collided=torch.zeros(5, dtype=torch.bool), num_particles=5)


@pytest.mark.parametrize("with_walls", [True, False])
def test_the_walls_readers(monkeypatch, with_walls):
    setup = small_setup()
    import program_spans
    t = types.SimpleNamespace(steps=2, window_s=4e-4, untraced_step_s=2e-4,
                              traffic={}, seed=0, state=planted_state(setup),
                              setup=setup)
    s = program_spans.reduce(fake_profile(with_walls), t)
    monkeypatch.setattr(program_spans, "of", lambda _t: s)
    got = {name: load(BENCH / "metrics" / f"{name}.py",
                      f"bench_metric_{name}").read(t) for name in READERS}
    if not with_walls:
        assert got == dict.fromkeys(READERS)
        return
    from counts import walls
    assert got["walls_ms_per_step"] == pytest.approx(0.020)
    assert got["walls_ops_per_step"] == 2.0
    bound, _ = walls.bound_ms(t.state, setup)
    assert got["walls_roofline_pct"] == pytest.approx(100.0 * bound / 0.020)
    monkeypatch.setattr(program_spans, "of", lambda _t: None)
    assert all(load(BENCH / "metrics" / f"{name}.py", f"bench_m_{name}")
               .read(t) is None for name in READERS)


def test_the_count_of_the_walls_job_on_a_planted_state():
    setup = small_setup()
    state = planted_state(setup)
    from counts import k8, roofline, walls
    assert walls.wall_lanes(state, setup) == 4
    assert walls.bytes_moved(5, 4) == 5 * (41 + 28 + 5) + 4 * 30 == 490
    assert walls.bound_ms(state, setup) == roofline.bound(490, 60 * 5)
    assert walls.bound_ms(state, setup) == k8.bound_ms(5, 4, 0)
    # At the cell's size the particles' bytes are 73,999,926 of it.
    assert walls.bytes_moved(999_999, 0) == 73_999_926
