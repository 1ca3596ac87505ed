"""The north star's deployment, the energized pore at 10M molecules
(``bench_torch/configs/tpore-10m.json``), on the CPU: the file is the 1M
configuration's but for its scale; at 10M the pairs engine's capacities
and grid keep every flat index the kernels take within int32, computed
from the configuration without allocating; the port and the benchmark's
plain reference agree through the file cut to a CPU's size, and a broken
step or a dropped particle reads false at the cell's limits; the three
set-up counters' readers (``bench_torch/metrics``).  Imports no JAX."""

import dataclasses
import importlib.util
import json
import shutil
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest

import argon_monte_carlo_tpu_torch as amt
from argon_monte_carlo_tpu_torch import config as C
from argon_monte_carlo_tpu_torch import engine
from argon_monte_carlo_tpu_torch.ops import collide

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench_torch"
CELL = "tpore-10m.pairs"
INT32_MAX = 2**31 - 1
SMALL = 1500
SAME = ("workload", "dtype", "nmft", "steps_per_mft", "num_timesteps",
        "reduced", "gas", "geometry", "thermal", "histogram", "engine")


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
    return load(BENCH / "harness.py", "bench_harness_10m")


@pytest.mark.parametrize("key", SAME)
def test_the_file_is_the_1m_file_but_for_its_scale(key):
    assert config("tpore-10m")[key] == config("tpore-1m")[key]


def test_the_count_is_what_the_program_and_the_reference_give(harness):
    cfg = config("tpore-10m")
    assert (cfg["name"], cfg["target_particles"]) == ("tpore-10m",
                                                      10_000_000)
    traffic = json.loads((BENCH / "traffic" / "pairs.json").read_text())
    pcfg = harness.program_config(amt, cfg, traffic)
    from reference import model
    assert pcfg.num_molecules == model.setup_from(cfg).n
    assert pcfg.num_molecules == cfg["num_particles"] == 9_999_991


def sizes(harness, name: str, monkeypatch) -> dict:
    """The pairs grid and capacities of a configuration, with the host's
    neighbour table (num_cells x 27 int32) left unbuilt."""
    monkeypatch.setattr(collide, "_build_neighbors",
                        lambda *_: np.empty((0, 27), dtype=np.int32))
    traffic = json.loads((BENCH / "traffic" / "pairs.json").read_text())
    pc = harness.program_config(amt, config(name), traffic)
    wl = amt.make_workload(pc)
    args = (pc.engine, pc.physics, pc.num_molecules, wl.fluid_volume)
    grid = collide.grid_for_pore(pc.geometry, C.cell_size_for(*args),
                                 C.pairs_cell_capacity_for(*args))
    return dict(n=pc.num_molecules, cells=grid.num_cells,
                cap=grid.capacity, pcfg=engine.pairs_config_for(wl))


def test_flat_indices_at_10m_fit_int32(harness, monkeypatch):
    s = sizes(harness, "tpore-10m", monkeypatch)
    n, rows, cap, p = s["n"], s["cells"] + 1, s["cap"], s["pcfg"]
    assert (s["cells"], cap) == (1_501_216, 24)
    assert (p.pair_capacity, p.event_capacity, p.research_capacity,
            p.append_capacity, p.top_k) == (4_196_608, 39_062, 39_517,
                                            117_494, 4)
    products = {
        "pos0 floats (K1 writes, K4 reads)": rows * cap * 3,
        "the table's slots (K2, K1)": rows * cap,
        "a run's 27 rows of slots (K1, K4)": rows * cap * 27,
        "neighbours (K1, K4)": s["cells"] * 27,
        "positions and velocities (K8)": n * 3,
        "paths (K8, K7c)": n * 4,
        "candidates (K1, K5)": n * p.top_k,
        "pair list (K3, K4)": p.pair_capacity,
    }
    assert max(products.values()) == rows * cap * 27 == 972_788_616
    assert all(v <= INT32_MAX for v in products.values()), products
    # Over 2x headroom at the north star's 10M.
    assert INT32_MAX / max(products.values()) > 2.2


@pytest.mark.parametrize("name, pos0, idx0, neighbors", [
    ("tpore-1m", 51_956_640, 17_318_880, 19_483_632),
    ("tpore-10m", 432_350_496, 144_116_832, 162_131_328),
])
def test_plane_bytes(harness, monkeypatch, name, pos0, idx0, neighbors):
    """The pair list's planes and the device grid's neighbour table, in
    bytes: ``PairList.init``'s shapes on the meta device, and the table's
    num_cells x 27 int32."""
    s = sizes(harness, name, monkeypatch)
    from argon_monte_carlo_tpu_torch.ops import pairs as pairs_ops
    grid = types.SimpleNamespace(num_cells=s["cells"], capacity=s["cap"])
    plist = pairs_ops.PairList.init(s["n"], grid, s["pcfg"],
                                    amt.EngineConfig().torch_dtype, "meta")

    def nbytes(t):
        return t.numel() * t.element_size()

    assert (nbytes(plist.pos0), nbytes(plist.idx0), nbytes(plist.reach0),
            s["cells"] * 27 * 4) == (pos0, idx0, idx0, neighbors)


@pytest.fixture
def small_bench(tmp_path):
    """The benchmark with ``tpore-10m`` cut to ~3,000 molecules and its
    mix to 8-step epochs (a CPU's time: the twins take ~0.5 s a step)."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "bench_torch",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    path = root / "bench_torch" / "configs" / "tpore-10m.json"
    cfg = json.loads(path.read_text())
    cfg["target_particles"] = SMALL
    del cfg["num_particles"]
    path.write_text(json.dumps(cfg))
    path = root / "bench_torch" / "traffic" / "pairs.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                    steps_per_epoch=8)))
    return root / "bench_torch"


def run_cell(harness, small_bench, trace=0):
    return harness.run_cell(
        ["--workload", CELL, "--seed", "3141592653", "--seconds", "0.1",
         "--trace", str(trace)], time.perf_counter(), device="cpu",
        bench_dir=small_bench)


def test_port_and_reference_agree_cut_small(harness, small_bench):
    out = run_cell(harness, small_bench, trace=1)
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["checked"]) == {"lanes_off_pct", "ledger_gap",
                                   "events_gap", "hist_gap",
                                   "dropped_per_million"}
    # A CPU run makes no graphs: of the three counters only the grid's.
    got = out["metrics"]
    assert "graph_held_gib" not in got and "capture_s" not in got
    assert got["grid_build_s"]["value"] > 0.0


def broken(kind):
    """A ``make_pairs_step_fn`` that breaks the step it makes."""
    def wrap(make):
        def made(*args, **kwargs):
            real = make(*args, **kwargs)

            def step(state, measure, *rest):
                if kind == "unchanged":
                    before = {f: getattr(state, f).clone()
                              for f in ("pos", "vel", "paths")}
                out = list(real(state, measure, *rest))
                if kind == "unchanged":
                    for f, t in before.items():
                        getattr(out[0], f).copy_(t)
                elif kind == "ledger":  # the hot wall's energy a tenth off
                    out[-1] = dataclasses.replace(
                        out[-1], energy_hot=out[-1].energy_hot * 1.1)
                else:  # a particle dropped from the search every step
                    out[1].overflow_count.add_(1)
                return tuple(out)
            return step
        return made
    return wrap


@pytest.mark.parametrize("kind", ["unchanged", "ledger", "dropped"])
def test_a_broken_step_is_not_correct_at_the_cells_limits(
        harness, small_bench, monkeypatch, kind):
    monkeypatch.setattr(engine, "make_pairs_step_fn",
                        broken(kind)(engine.make_pairs_step_fn))
    out = run_cell(harness, small_bench)
    assert out["correct"] is False, out["checked"]


def metric(name: str):
    return load(BENCH / "metrics" / f"{name}.py", f"bench_metric_{name}")


@pytest.mark.parametrize("name, counters, value", [
    ("graph_held_gib", {}, None),
    ("graph_held_gib", {"graph_held_bytes": None}, None),
    ("graph_held_gib", {"graph_held_bytes": 3 * 2**29}, 1.5),
    ("capture_s", {}, None),
    ("capture_s", {"capture_s": None}, None),
    ("capture_s", {"capture_s": 2.5}, 2.5),
    ("grid_build_s", {}, None),
    ("grid_build_s", {"grid_build_s": None}, None),
    ("grid_build_s", {"grid_build_s": 0.58}, 0.58),
])
def test_the_counters_readers(name, counters, value):
    t = types.SimpleNamespace(sim=types.SimpleNamespace(**counters))
    assert metric(name).read(t) == value


@pytest.mark.parametrize("kind", ["pairs", "allpairs"])
def test_the_counters_on_a_cpu_run(kind):
    if kind == "allpairs":
        cfg = amt.CubeConfig(num_particles_override=500,
                             engine=amt.EngineConfig(broadphase="allpairs"))
    else:
        cfg = amt.temperature_pore_config(engine=amt.EngineConfig(
            narrowphase="pairs", rebuild_interval=8,
            steps_per_epoch=5)).scaled_to(SMALL)
    sim = amt.Simulation(amt.make_workload(cfg), device="cpu")
    state, measure, gen = sim.init(7)
    sim.run(num_steps=5, state=state, measure=measure, generator=gen)
    t = types.SimpleNamespace(sim=sim)
    assert metric("graph_held_gib").read(t) is None
    assert metric("capture_s").read(t) is None
    grid = metric("grid_build_s").read(t)
    assert (grid is None) == (kind == "allpairs")
    assert grid is None or grid > 0.0
