"""The pairs step updates its own tensors in place (K3, K4 and K7's
compacted entry); what that leans on and what it must not touch, on the
CPU with the plain twins, in both pores:

- ``Simulation.run`` copies what its caller hands it, so the caller's state
  and measurements stay bitwise as they were, also across runs that carry
  the pair list;
- the staging keeps a row whose mask is clear at zero whenever the step
  flushes it, so the compacted flush may clear only the staged rows, and
  the events it is given ascend.
"""

import dataclasses

import pytest
import torch

import argon_monte_carlo_tpu_torch as amt
from argon_monte_carlo_tpu_torch.ops import measure as tmeasure

TARGET = 3000
K = 4
PORES = {"temperature": amt.temperature_pore_config, "specular": amt.PoreConfig}


def pairs_sim(pore):
    cfg = PORES[pore](num_particles_override=TARGET,
                      engine=amt.EngineConfig(narrowphase="pairs",
                                              rebuild_interval=K,
                                              steps_per_epoch=K))
    return amt.Simulation(amt.make_workload(cfg), device="cpu")


def start(sim):
    """The initial state with every particle's partial path already ended,
    so every pair collision stages a completed path; the measurements and
    the Generator that goes on to draw the steps."""
    state, meas, gen = sim.init()
    state = dataclasses.replace(
        state, has_collided=torch.ones_like(state.has_collided))
    return state, meas, gen


def snapshot(obj):
    return {f.name: getattr(obj, f.name).clone()
            for f in dataclasses.fields(obj)}


def assert_as_snapshot(obj, snap):
    for name, kept in snap.items():
        assert torch.equal(getattr(obj, name), kept), name


@pytest.mark.parametrize("pore", sorted(PORES))
def test_run_leaves_callers_state_and_measurements_untouched(pore):
    """Two runs of the pairs engine, the second on what the first returned
    (the window and the pair list carry over): neither run writes a tensor
    it was handed, and the carried run equals one run of all the steps."""
    sim = pairs_sim(pore)
    state, meas, gen = start(sim)
    given_state, given_meas = snapshot(state), snapshot(meas)
    s1, m1, met1 = sim.run(num_steps=6, state=state, measure=meas,
                           generator=gen)
    assert_as_snapshot(state, given_state)
    assert_as_snapshot(meas, given_meas)
    assert int(m1.collision_count) > 0 and int(m1.path_count) > 0
    first_state, first_meas = snapshot(s1), snapshot(m1)
    s2, m2, met2 = sim.run(num_steps=6, state=s1, measure=m1, generator=gen,
                           start_step=6)
    assert_as_snapshot(s1, first_state)
    assert_as_snapshot(m1, first_meas)
    assert met1.rebuilt.tolist() + met2.rebuilt.tolist() == [1, 0, 0, 0] * 3

    # The caller's initial state, never written, starts the whole run.
    _, _, gen = sim.init()
    whole, whole_meas, _ = sim.run(num_steps=12, state=state, measure=meas,
                                   generator=gen)
    for f in ("pos", "vel", "paths", "has_collided"):
        assert torch.equal(getattr(s2, f), getattr(whole, f)), f
    for f in ("hist", "path_sum", "path_count", "collision_count"):
        assert torch.equal(getattr(m2, f), getattr(whole_meas, f)), f


@pytest.mark.parametrize("pore", sorted(PORES))
def test_unstaged_rows_are_zero_at_every_flush(pore, monkeypatch):
    """At every flush of the pairs step a row of the staging whose mask is
    clear is zero (the writers stage a row only where they set its mask,
    and every flush clears what was staged), and the engine's event_idx
    ascends."""
    flush = tmeasure.flush_hist_compacted
    seen = []

    def spy(measure, event_idx, num_bins, hist_hi):
        vals, mask = measure.pending_vals, measure.pending_mask
        assert not vals[~mask].any()
        tmeasure.check_event_idx(event_idx, vals.shape[0])
        seen.append(int(mask.sum()))
        out = flush(measure, event_idx, num_bins, hist_hi)
        assert not out.pending_vals.any() and not out.pending_mask.any()
        return out

    monkeypatch.setattr(tmeasure, "flush_hist_compacted", spy)
    sim = pairs_sim(pore)
    state, meas, gen = start(sim)
    _, meas, _ = sim.run(num_steps=12, state=state, measure=meas,
                         generator=gen)
    assert len(seen) == 12
    assert sum(seen) == int(meas.path_count) > 0
