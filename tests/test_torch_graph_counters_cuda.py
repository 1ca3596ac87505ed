"""The set-up counters of a replayed pairs run on the card (marked ``cuda``;
skipped where no card is present): ``Simulation.grid_build_s``,
``capture_s`` and ``graph_held_bytes``.

Imports no JAX; on a machine with the card and without JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_graph_counters_cuda.py

The pore at ~50k particles, pairs K = 8, 100-step epochs.
"""

import dataclasses

import pytest
import torch

import argon_monte_carlo_tpu_torch as amt

pytestmark = pytest.mark.cuda

TARGET, K, PER_EPOCH, SEED = 50_000, 8, 100, 29


@pytest.fixture
def sim():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphs replay CUDA kernels")
    cfg = amt.temperature_pore_config(engine=amt.EngineConfig(
        narrowphase="pairs", rebuild_interval=K,
        steps_per_epoch=PER_EPOCH)).scaled_to(TARGET)
    return amt.Simulation(amt.make_workload(cfg), device="cuda")


def test_counters_after_a_replayed_run(sim):
    assert sim.grid_build_s > 0.0
    assert sim.capture_s is None and sim.graph_held_bytes is None
    state, measure, gen = sim.init(SEED)
    state, measure, _ = sim.run(num_steps=30, state=state, measure=measure,
                                generator=gen)
    torch.cuda.synchronize()
    assert sim.replayed_steps == 28
    first = sim.capture_s
    assert first > 0.0
    graphs = sim._graphs
    inputs = sum({t.untyped_storage().data_ptr():
                  t.untyped_storage().nbytes() for t in (
                      [getattr(o, f.name) for o in (graphs.state,
                                                    graphs.measure,
                                                    graphs.plist)
                       for f in dataclasses.fields(o)]
                      + [graphs.uniforms])}.values())
    # The inputs at least, and the pool's segments on top of them.
    assert sim.graph_held_bytes > inputs
    held = sim.graph_held_bytes
    # A second run replays both graphs: no capture, nothing more held.
    sim.run(num_steps=30, state=state, measure=measure, generator=gen,
            start_step=30)
    torch.cuda.synchronize()
    assert sim.replayed_steps == 58
    assert sim.capture_s == first
    assert sim.graph_held_bytes == held
