"""``Simulation.run``'s choice between its loop and the CUDA-graph replay
of the pairs step, on the CPU.

The rule (``engine.replays_steps``) case by case; a CPU run never
replays; the graphs' body (``StepGraphs.run_body``: the step on fixed
inputs, the copies back and the metrics' rows), run eagerly where a
replay would run it, equals the loop bitwise -- with the generator's
draws and with ``draw=``, across runs and epochs that cut the pair list's
window, with a loop run in between, resumed from a checkpoint -- and
leaves its caller's tensors alone; the benchmark's ``graph_steps_pct``
reads the counters.  The pore at 3,000 particles, pairs K = 8."""

import dataclasses
import importlib.util
import types
from pathlib import Path

import pytest
import torch

import argon_monte_carlo_tpu_torch as amt
from argon_monte_carlo_tpu_torch import engine
from argon_monte_carlo_tpu_torch.io import checkpoint as ckpt
from argon_monte_carlo_tpu_torch.state import StepMetrics

K, PER_EPOCH, SEED = 8, 7, 5
METRIC = (Path(__file__).resolve().parent.parent / "bench_torch" / "metrics"
          / "graph_steps_pct.py")


def simulation(kind: str = "pairs") -> amt.Simulation:
    if kind == "cube":
        cfg = amt.CubeConfig(num_particles_override=1000,
                             engine=amt.EngineConfig(
                                 broadphase="allpairs",
                                 steps_per_epoch=PER_EPOCH))
    else:
        eng = (amt.EngineConfig(narrowphase="pairs", rebuild_interval=K,
                                steps_per_epoch=PER_EPOCH)
               if kind == "pairs" else
               amt.EngineConfig(steps_per_epoch=PER_EPOCH))
        cfg = amt.temperature_pore_config(engine=eng).scaled_to(3000)
    return amt.Simulation(amt.make_workload(cfg), device="cpu")


@pytest.mark.parametrize("narrowphase, device, profiling, replays", [
    ("pairs", "cuda", False, True),
    ("pairs", "cuda:0", False, True),
    ("pairs", torch.device("cuda", 1), False, True),
    ("pairs", "cuda", True, False),
    ("pairs", "cpu", False, False),
    ("pairs", torch.device("cpu"), True, False),
    ("sweep", "cuda", False, False),
    ("sweep", "cuda", True, False),
    ("sweep", "cpu", False, False),
])
def test_the_rule(narrowphase, device, profiling, replays):
    assert engine.replays_steps(narrowphase, device, profiling) is replays


@pytest.mark.parametrize("kind", ["pairs", "sweep", "cube"])
def test_a_cpu_run_never_replays(kind):
    sim = simulation(kind)
    state, measure, gen = sim.init(SEED)
    state, measure, _ = sim.run(num_steps=9, state=state, measure=measure,
                                generator=gen)
    sim.run(num_steps=4, state=state, measure=measure, generator=gen,
            start_step=9)
    assert (sim.replayed_steps, sim.looped_steps) == (0, 13)
    assert sim._graphs is None


def eager_replays(monkeypatch):
    """Make ``run`` take the graph path on the CPU, with each "replay"
    the graphs' body run eagerly."""
    def step(self, rebuilt):
        self.run_body(rebuilt)
        return True

    monkeypatch.setattr(engine, "replays_steps",
                        lambda narrowphase, *_: narrowphase == "pairs")
    monkeypatch.setattr(engine.StepGraphs, "step", step)


def tensors(*objs):
    return {f"{type(o).__name__}.{f.name}": getattr(o, f.name)
            for o in objs for f in dataclasses.fields(o)}


def assert_same(got, want):
    a, b = tensors(*got), tensors(*want)
    assert a.keys() == b.keys()
    assert [k for k in a if not torch.equal(a[k], b[k])] == []
    assert [k for k in a if a[k].stride() != b[k].stride()] == []


def chunks(sim, sizes, draw=None, loop_in=()):
    """``sim`` from its seed through runs of ``sizes`` steps (those whose
    index is in ``loop_in`` forced onto the loop): every run's metrics,
    then the last state and measurements."""
    state, measure, gen = sim.init(SEED)
    out, step = [], 0
    for k, count in enumerate(sizes):
        with pytest.MonkeyPatch.context() as m:
            if k in loop_in:
                m.setattr(engine, "replays_steps", lambda *_: False)
            state, measure, metrics = sim.run(
                num_steps=count, state=state, measure=measure, generator=gen,
                start_step=step, draw=draw)
        out.append(metrics)
        step += count
    return out, state, measure


def assert_runs_equal(a, b, sim_a, sim_b):
    (ma, sa, mea), (mb, sb, meb) = a, b
    for x, y in zip(ma, mb):
        assert_same((x,), (y,))
    assert_same((sa, mea), (sb, meb))
    assert_same((sim_a.pair_window()[0],), (sim_b.pair_window()[0],))
    assert sim_a.pair_window()[1] == sim_b.pair_window()[1]


@pytest.mark.parametrize("sizes", [[20], [20, 13], [3, 5, 1, 16]])
def test_graph_body_equals_the_loop(monkeypatch, sizes):
    loop_sim = simulation()
    want = chunks(loop_sim, sizes)
    eager_replays(monkeypatch)
    sim = simulation()
    got = chunks(sim, sizes)
    assert_runs_equal(got, want, sim, loop_sim)
    assert (sim.replayed_steps, sim.looped_steps) == (sum(sizes), 0)


def test_graph_body_with_a_draw_function(monkeypatch):
    def draws():
        gen = torch.Generator()
        gen.manual_seed(9)
        return lambda _i: torch.rand((3000, 2), generator=gen)

    loop_sim = simulation()
    want = chunks(loop_sim, [10, 11], draw=draws())
    eager_replays(monkeypatch)
    sim = simulation()
    assert_runs_equal(chunks(sim, [10, 11], draw=draws()), want, sim,
                      loop_sim)


def test_a_loop_run_between_graph_runs(monkeypatch):
    loop_sim = simulation()
    want = chunks(loop_sim, [9, 6, 10])
    eager_replays(monkeypatch)
    sim = simulation()
    assert_runs_equal(chunks(sim, [9, 6, 10], loop_in={1}), want, sim,
                      loop_sim)
    assert (sim.replayed_steps, sim.looped_steps) == (19, 6)


def test_graph_runs_resume_from_a_checkpoint(monkeypatch, tmp_path):
    loop_sim = simulation()
    _, want_state, want_measure = chunks(loop_sim, [11, 14])
    eager_replays(monkeypatch)
    sim = simulation()
    state, measure, gen = sim.init(SEED)
    state, measure, _ = sim.run(num_steps=11, state=state, measure=measure,
                                generator=gen)
    path = ckpt.save_checkpoint(str(tmp_path / "c.npz"), state, measure, gen,
                                11, pair_window=sim.pair_window())
    again = simulation()
    state, measure, gen, step = ckpt.load_checkpoint(path, "cpu")
    again.resume_pair_window(state, *ckpt.load_pair_window(path, "cpu"))
    state, measure, _ = again.run(num_steps=14, state=state, measure=measure,
                                  generator=gen, start_step=step)
    assert_same((state, measure), (want_state, want_measure))
    assert_same((again.pair_window()[0],), (loop_sim.pair_window()[0],))
    assert again.pair_window()[1] == loop_sim.pair_window()[1]


def test_graph_run_leaves_its_callers_tensors(monkeypatch):
    eager_replays(monkeypatch)
    sim = simulation()
    state, measure, gen = sim.init(SEED)
    given = {k: t.clone() for k, t in tensors(state, measure).items()}
    seen = []
    out = sim.run(num_steps=9, state=state, measure=measure, generator=gen,
                  epoch_callback=seen.append)
    after = tensors(state, measure)
    assert [k for k in given if not torch.equal(given[k], after[k])] == []
    inputs = {t.data_ptr() for t in tensors(sim._graphs.state,
                                            sim._graphs.measure).values()}
    assert not inputs & {t.data_ptr() for t in tensors(*out[:2]).values()}
    assert [m.collisions.shape[0] for m in seen] == [PER_EPOCH, 2]
    assert_same((StepMetrics.concat(seen),), (out[2],))


def read_metric(sim):
    spec = importlib.util.spec_from_file_location("graph_steps_pct", METRIC)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(types.SimpleNamespace(sim=sim))


@pytest.mark.parametrize("counters, share", [
    (None, None),
    ({"replayed_steps": 0, "looped_steps": 0}, None),
    ({"replayed_steps": 0, "looped_steps": 400}, 0.0),
    ({"replayed_steps": 99_000, "looped_steps": 1_000}, 99.0),
])
def test_graph_steps_pct_reads_the_counters(counters, share):
    sim = types.SimpleNamespace(**(counters or {}))
    assert read_metric(sim) == share


def test_graph_steps_pct_on_a_cpu_run():
    sim = simulation()
    state, measure, gen = sim.init(SEED)
    sim.run(num_steps=3, state=state, measure=measure, generator=gen)
    assert read_metric(sim) == 0.0


def test_copy_back_counter_counts_what_the_body_copies(monkeypatch):
    """``StepGraphs.copy_back_bytes`` is the bytes of the fields each body
    copied back (those the step made anew), and
    ``Simulation.copy_back_bytes_per_step`` their mean over a window; K8
    and the other in-place stages leave vel, paths, has_collided and the
    staging for no copy; ``copy_back_mib_per_step`` reads the mean."""
    copy_into = engine.copy_into
    copied = {True: [], False: []}
    body = engine.StepGraphs.run_body
    kind = []

    def spy(static, obj):
        names = [f.name for f in dataclasses.fields(obj)
                 if getattr(static, f.name).data_ptr()
                 != getattr(obj, f.name).data_ptr()]
        sizes = [getattr(static, f).numel() * getattr(static, f).element_size()
                 for f in names]
        out = copy_into(static, obj)
        if kind:
            copied[kind[-1]].append((type(obj).__name__, names))
            assert out == sum(sizes)
        return out

    def flagged(self, rebuilt):
        copied[rebuilt].clear()
        kind.append(rebuilt)
        try:
            body(self, rebuilt)
        finally:
            kind.pop()

    eager_replays(monkeypatch)
    monkeypatch.setattr(engine, "copy_into", spy)
    monkeypatch.setattr(engine.StepGraphs, "run_body", flagged)
    sim = simulation()
    assert sim.copy_back_bytes_per_step is None
    state, measure, gen = sim.init(SEED)
    sim.run(num_steps=K + 2, state=state, measure=measure, generator=gen)
    g = sim._graphs
    for rebuilt in (True, False):
        fields = {f"{cls}.{name}" for cls, names in copied[rebuilt]
                  for name in names}
        assert not fields & {"ParticleState.vel", "ParticleState.paths",
                             "ParticleState.has_collided",
                             "Measurements.pending_vals",
                             "Measurements.pending_mask"}, fields
        assert g.copy_back_bytes[rebuilt] > 0
    # The rebuilding body copies the new list in, the plain one does not.
    assert g.copy_back_bytes[True] > g.copy_back_bytes[False]
    assert sim.copy_back_bytes_per_step == (
        g.copy_back_bytes[False] * (K - 1) + g.copy_back_bytes[True]) / K
    metric = (METRIC.parent / "copy_back_mib_per_step.py")
    spec = importlib.util.spec_from_file_location("copy_back", metric)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.read(types.SimpleNamespace(sim=sim)) == (
        sim.copy_back_bytes_per_step / 2**20)
