"""``Simulation.run``'s CUDA-graph replay of the pairs step against its
loop on the card (marked ``cuda``; skipped where no card is present).

Imports no JAX; on a machine with the card and without JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_graphs_cuda.py

The pore at ~50k particles, pairs K = 8, 100-step epochs, 250 steps.  The
loop is forced by making ``engine.replays_steps`` say no; the replay runs
the same kernels in the same order, so every comparison is bitwise: the
state, the measurements, the ``StepMetrics``, the carried pair list and
its window, and the launches ``kernels.launch_counts`` counts.
"""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import argon_monte_carlo_tpu_torch as amt
from argon_monte_carlo_tpu_torch import engine, kernels
from argon_monte_carlo_tpu_torch.io import checkpoint as ckpt
from argon_monte_carlo_tpu_torch.state import StepMetrics

pytestmark = pytest.mark.cuda

TARGET, K, PER_EPOCH, STEPS, SEED = 50_000, 8, 100, 250, 23


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphs replay CUDA kernels")
    return torch.device("cuda")


def simulation(device) -> amt.Simulation:
    cfg = amt.temperature_pore_config(engine=amt.EngineConfig(
        narrowphase="pairs", rebuild_interval=K,
        steps_per_epoch=PER_EPOCH)).scaled_to(TARGET)
    return amt.Simulation(amt.make_workload(cfg), device=device)


def loop_only(monkeypatch):
    monkeypatch.setattr(engine, "replays_steps", lambda *args: False)


def run(sim, chunks, draw=None, profiled=()):
    """``sim`` from its seed through runs of ``chunks`` steps (the ones
    whose index is in ``profiled`` under a torch profiler): the last
    run's output and the launches of all of them."""
    state, measure, gen = sim.init(SEED)
    kernels.launch_counts.clear()
    step, metrics = 0, []
    for k, count in enumerate(chunks):
        args = dict(num_steps=count, state=state, measure=measure,
                    generator=gen, start_step=step, draw=draw)
        if k in profiled:
            with profile(activities=[ProfilerActivity.CPU]):
                state, measure, m = sim.run(**args)
        else:
            state, measure, m = sim.run(**args)
        metrics.append(m)
        step += count
    torch.cuda.synchronize()
    return (state, measure, StepMetrics.concat(metrics),
            dict(kernels.launch_counts))


def tensors(*objs):
    return {f"{type(o).__name__}.{f.name}": getattr(o, f.name)
            for o in objs for f in dataclasses.fields(o)}


def assert_same(got, want):
    a, b = tensors(*got), tensors(*want)
    assert a.keys() == b.keys()
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    assert differ == []


def assert_runs_equal(replayed, looped):
    (s1, m1, t1, l1), sim1 = replayed
    (s2, m2, t2, l2), sim2 = looped
    assert_same((s1, m1, t1), (s2, m2, t2))
    assert_same(sim1.pair_window()[:1], sim2.pair_window()[:1])
    assert sim1.pair_window()[1] == sim2.pair_window()[1]
    assert l1 == l2


@pytest.fixture
def loop_250(device, monkeypatch):
    sim = simulation(device)
    with monkeypatch.context() as m:
        loop_only(m)
        out = run(sim, [STEPS])
    return out, sim


def test_replay_equals_the_loop_bitwise(device, loop_250):
    sim = simulation(device)
    out = run(sim, [STEPS])
    assert_runs_equal((out, sim), loop_250)


def test_replayed_and_looped_steps(device, loop_250):
    sim = simulation(device)
    run(sim, [STEPS])
    # Step 0 rebuilds and step 1 does not: each runs eagerly once before
    # its graph is captured at its kind's next step.
    assert (sim.replayed_steps, sim.looped_steps) == (STEPS - 2, 2)
    assert (loop_250[1].replayed_steps, loop_250[1].looped_steps) == (
        0, STEPS)


def test_launch_counts_equal_the_loops(device, loop_250):
    sim = simulation(device)
    launches = run(sim, [STEPS])[3]
    assert launches == loop_250[0][3]
    assert launches["pore_advance"] == STEPS
    assert launches["rebuild_sweep"] == -(-STEPS // K)


def test_post_pairs_once_a_pairs_step(device, loop_250):
    """K13 runs once a pairs step, looped and replayed (a replay adds what
    its graph recorded), and never in the sweep."""
    sim = simulation(device)
    assert run(sim, [STEPS])[3]["post_pairs"] == STEPS
    assert loop_250[0][3]["post_pairs"] == STEPS
    cfg = dataclasses.replace(
        sim.cfg, engine=dataclasses.replace(sim.cfg.engine,
                                            narrowphase="sweep",
                                            rebuild_interval=1))
    sweep = amt.Simulation(amt.make_workload(cfg), device=device)
    assert run(sweep, [20])[3].get("post_pairs", 0) == 0


def test_draw_function(device, monkeypatch):
    def draws(n):
        gen = torch.Generator(device=device)
        gen.manual_seed(5)
        return lambda _i: torch.rand((n, 2), generator=gen, device=device)

    sim, looped_sim = simulation(device), simulation(device)
    n = sim.cfg.num_molecules
    replayed = run(sim, [30, 20], draw=draws(n))
    assert sim.replayed_steps == 48
    with monkeypatch.context() as m:
        loop_only(m)
        looped = run(looped_sim, [30, 20], draw=draws(n))
    assert_runs_equal((replayed, sim), (looped, looped_sim))


def test_profiled_run_between_graph_runs(device, loop_250):
    sim = simulation(device)
    out = run(sim, [100, 50, 100], profiled={1})
    assert_runs_equal((out, sim), loop_250)
    # The profiled run took the loop.
    assert (sim.replayed_steps, sim.looped_steps) == (198, 52)


def test_checkpoint_resume_is_exact(device, loop_250, tmp_path):
    sim = simulation(device)
    state, measure, gen = sim.init(SEED)
    state, measure, _ = sim.run(num_steps=131, state=state, measure=measure,
                                generator=gen)
    path = ckpt.save_checkpoint(str(tmp_path / "c.npz"), state, measure, gen,
                                131, pair_window=sim.pair_window())
    again = simulation(device)
    state, measure, gen, step = ckpt.load_checkpoint(path, device)
    again.resume_pair_window(state, *ckpt.load_pair_window(path, device))
    state, measure, _ = again.run(num_steps=STEPS - step, state=state,
                                  measure=measure, generator=gen,
                                  start_step=step)
    assert again.replayed_steps == STEPS - step - 2
    want = loop_250[0]
    assert_same((state, measure), want[:2])
    assert_same(again.pair_window()[:1], loop_250[1].pair_window()[:1])
    assert again.pair_window()[1] == loop_250[1].pair_window()[1]


def test_caller_owns_its_tensors(device):
    sim = simulation(device)
    state, measure, gen = sim.init(SEED)
    given = {k: t.clone() for k, t in tensors(state, measure).items()}
    out = sim.run(num_steps=20, state=state, measure=measure, generator=gen)
    after = tensors(state, measure)
    assert [k for k in given if not torch.equal(given[k], after[k])] == []
    graph_inputs = {t.data_ptr() for t in tensors(
        sim._graphs.state, sim._graphs.measure).values()}
    assert not graph_inputs & {
        t.data_ptr() for t in tensors(*out[:2]).values()}


def test_plain_step_copies_back_only_0d_fields(device, loop_250):
    """The replayed plain step copies back nothing but 0-d fields (K8, K3,
    K13, K4 and K7c update the step's state, staging and list in place):
    at most 64 bytes; the rebuilding step also copies the new list in.
    The replay stays bitwise the loop."""
    sim = simulation(device)
    out = run(sim, [STEPS])
    assert_runs_equal((out, sim), loop_250)
    copied = sim._graphs.copy_back_bytes
    assert 0 < copied[False] <= 64
    assert copied[True] > 1000 * copied[False]
    assert sim.copy_back_bytes_per_step == (
        copied[False] * (K - 1) + copied[True]) / K
