"""The slices as a whole: the port's sweep and pairs engines against the JAX
``Simulation`` (cells broad phase), and the pairs engine against the
port's own sweep engine.

Both start from the reference's initial state (carried across with
``convert.state_from_numpy``) and the port gets the reference's per-step
uniforms through ``draw``, so the trajectories are the same up to rounding.
The sweep runs with the exact flush (every step) and a 3-step flush window;
the pairs engine with K=5.  Tolerances, checked after every step: per-step
collisions, wall hits, recaptures (and the pairs engine's rebuilt and
latency counters), the histogram, the staging mask, path_count and every
counter exact; state within 1e-12 relative (float64); ledger and path_sum
within 1e-9 relative (sums over a few events taken in another order).  The
pairs engine's dirty_count may differ by at most the particles whose speed
the step moved by no more than one ulp: the reference's bump mask compares
speeds from XLA's FMA-contracted sum of squares, so a speed-keeping
reflection can read as changed on one side only (a dirty particle is only
re-searched, so no trajectory moves).  The pairs engine equals the port's
sweep engine bitwise, as the reference's pairs engine equals its sweep
(test_pairs.py:43).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import argon_monte_carlo_tpu as amc
import argon_monte_carlo_tpu_torch as amt
from argon_monte_carlo_tpu.config import EngineConfig as JEngine
from argon_monte_carlo_tpu_torch import convert
from argon_monte_carlo_tpu_torch.ops import measure as tmeasure
from argon_monte_carlo_tpu_torch.ops import oob as toob

STEPS = 10
EXACT_METRICS = ("collisions", "wall_hits", "oob_after_walls",
                 "oob_after_pairs")
PAIRS_METRICS = ("rebuilt", "latent_full", "teleports", "latent_research")
LEDGER = ("momentum_z", "energy_hot", "energy_cold")
COUNTERS = ("path_count", "collision_count", "err_count", "overflow_count",
            "hist_drop_count", "hot_spill_count")


def both_simulations(target, **engine):
    jcfg = amc.temperature_pore_config(engine=JEngine(
        broadphase="cells", dtype="float64", **engine)).scaled_to(target)
    tcfg = amt.temperature_pore_config(engine=amt.EngineConfig(
        dtype="float64", **engine)).scaled_to(target)
    return (amc.Simulation(amc.make_workload(jcfg)),
            amt.Simulation(amt.make_workload(tcfg), device="cpu"))


def start_from_reference(jsim):
    """The reference's initial state on both sides, and a draw that hands
    the port the reference's per-step uniforms."""
    jstate, jmeas, run_key = jsim.init()
    n = jstate.num_particles
    arrays = {f: np.asarray(getattr(jstate, f))
              for f in ("pos", "vel", "paths", "has_collided")}
    arrays.update({f: np.asarray(getattr(jmeas, f)) for f in
                   ("hist", "path_sum", "pending_vals", "pending_mask")
                   + COUNTERS})
    tstate, tmeas = convert.state_from_numpy(arrays, "cpu", torch.float64)

    def draw(i):
        key = jax.random.fold_in(run_key, i)
        return torch.from_numpy(np.array(
            jax.random.uniform(key, (n, 2), jnp.float64)))

    return jstate, jmeas, run_key, tstate, tmeas, draw


def assert_step_matches(i, metric_names, j, t):
    """One step's (state, measure, metrics) of both engines agree."""
    (jstate, jmeas, jmet), (tstate, tmeas, tmet) = j, t
    for f in metric_names:
        assert tmet_value(tmet, f) == int(np.asarray(getattr(jmet, f))[0]), (
            i, f)
    for f in LEDGER:
        assert float(getattr(tmet, f)[0]) == pytest.approx(
            float(np.asarray(getattr(jmet, f))[0]), rel=1e-9, abs=1e-35)
    for f in COUNTERS:
        assert int(getattr(tmeas, f)) == int(getattr(jmeas, f)), (i, f)
    np.testing.assert_array_equal(tmeas.hist.numpy(), np.asarray(jmeas.hist))
    np.testing.assert_allclose(tmeas.path_sum.numpy(),
                               np.asarray(jmeas.path_sum), rtol=1e-9)
    for f in ("pos", "vel", "paths"):
        want = np.asarray(getattr(jstate, f))
        np.testing.assert_allclose(getattr(tstate, f).numpy(), want,
                                   rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())
    np.testing.assert_array_equal(tstate.has_collided.numpy(),
                                  np.asarray(jstate.has_collided))
    np.testing.assert_array_equal(tmeas.pending_mask.numpy(),
                                  np.asarray(jmeas.pending_mask))


def speed_ties(before, after) -> int:
    """Particles whose velocity changed but whose speed (the port's
    formula) moved by at most one ulp."""
    s0 = tmeasure.speed(before.vel).numpy()
    s1 = tmeasure.speed(after.vel).numpy()
    changed = (before.vel != after.vel).any(dim=-1).numpy()
    return int((changed & (np.abs(s1 - s0) <= np.spacing(s0))).sum())


def run_step_by_step(jsim, tsim, steps, metric_names):
    """Both engines one step at a time from the reference's state; returns
    the port's per-step metrics."""
    jstate, jmeas, run_key, tstate, tmeas, draw = start_from_reference(jsim)
    metrics = []
    for i in range(steps):
        before = tstate
        jstate, jmeas, jmet = jsim.run(num_steps=1, state=jstate,
                                       measure=jmeas, run_key=run_key,
                                       start_step=i)
        tstate, tmeas, tmet = tsim.run(num_steps=1, state=tstate,
                                       measure=tmeas, start_step=i,
                                       draw=draw)
        assert_step_matches(i, metric_names, (jstate, jmeas, jmet),
                            (tstate, tmeas, tmet))
        gap = abs(tmet_value(tmet, "dirty_count")
                  - int(np.asarray(jmet.dirty_count)[0]))
        assert gap <= speed_ties(before, tstate), (i, "dirty_count")
        metrics.append(tmet)
    assert int(tmeas.path_count) > 0
    return amt.state.StepMetrics.concat(metrics)


@pytest.mark.parametrize("flush_interval", [1, 3])
def test_sweep_engine_matches_reference_step_by_step(flush_interval):
    jsim, tsim = both_simulations(4000, hist_flush_interval=flush_interval)
    met = run_step_by_step(jsim, tsim, STEPS, EXACT_METRICS)
    assert int((met.collisions - met.wall_hits).sum()) > 0


@pytest.mark.parametrize("capacity", [None, 4])
def test_pairs_engine_matches_reference_step_by_step(capacity):
    """15 steps at K=5: three windows, so three rebuilds, each followed by
    the one-shot re-search of its full emissions.  Capacity 4 starves the
    pairs grid: a third of the particles spill hot at every rebuild."""
    jsim, tsim = both_simulations(3000, narrowphase="pairs",
                                  rebuild_interval=5, steps_per_epoch=5,
                                  cell_capacity=capacity)
    met = run_step_by_step(jsim, tsim, 15, EXACT_METRICS + PAIRS_METRICS)
    assert met.rebuilt.tolist() == [1, 0, 0, 0, 0] * 3
    assert int((met.collisions - met.wall_hits).sum()) > 0
    assert int(met.dirty_count.sum()) > 0


def tmet_value(metrics, field):
    return int(getattr(metrics, field)[0])


def port_run(steps, target=3000, **engine):
    cfg = amt.temperature_pore_config(engine=amt.EngineConfig(
        dtype="float64", steps_per_epoch=5, **engine)).scaled_to(target)
    return amt.Simulation(amt.make_workload(cfg), device="cpu").run(
        num_steps=steps)


def test_pairs_engine_matches_port_sweep_bitwise():
    """The pairs engine against the port's sweep engine, 15 steps, K=5."""
    st_s, m_s, _ = port_run(15)
    st_p, m_p, met_p = port_run(15, narrowphase="pairs", rebuild_interval=5)
    for f in ("pos", "vel", "paths", "has_collided"):
        assert torch.equal(getattr(st_p, f), getattr(st_s, f)), f
    for f in ("hist", "path_sum", "path_count", "collision_count"):
        assert torch.equal(getattr(m_p, f), getattr(m_s, f)), f
    assert int(m_p.collision_count) > 0
    assert int(m_p.overflow_count) == 0
    assert int(met_p.dirty_count.sum()) > 0


def test_pairs_window_carry():
    """The window carries across runs: 5 + 5 steps equal 10 steps.  A
    state other than the one the last run returned (here a copy, as a
    checkpoint load gives) drops the pair list and rebuilds at once,
    without changing the trajectory."""
    cfg = amt.temperature_pore_config(engine=amt.EngineConfig(
        dtype="float64", narrowphase="pairs", rebuild_interval=5,
        steps_per_epoch=5)).scaled_to(3000)
    sim = amt.Simulation(amt.make_workload(cfg), device="cpu")
    whole_state, whole_meas, whole = sim.run(num_steps=10)
    assert whole.rebuilt.tolist() == [1, 0, 0, 0, 0] * 2

    for split, copy in ((5, False), (3, True)):
        state, meas, gen = sim.init()
        state, meas, first = sim.run(num_steps=split, state=state,
                                     measure=meas, generator=gen)
        if copy:
            state = dataclasses.replace(state)
        state, meas, second = sim.run(num_steps=10 - split, state=state,
                                      measure=meas, generator=gen,
                                      start_step=split)
        flags = first.rebuilt.tolist() + second.rebuilt.tolist()
        if copy:
            assert flags == [1, 0, 0, 1, 0, 0, 0, 0, 1, 0]
        else:
            assert flags == whole.rebuilt.tolist()
        assert torch.equal(state.pos, whole_state.pos)
        assert torch.equal(state.vel, whole_state.vel)
        assert torch.equal(meas.hist, whole_meas.hist)


def test_port_run_invariants():
    """The port on its own Generator: the invariants of the reference's
    temperature-pore engine test, plus a repeatable run per seed."""
    cfg = amt.temperature_pore_config(
        engine=amt.EngineConfig(dtype="float64", steps_per_epoch=10),
    ).scaled_to(8000)
    sim = amt.Simulation(amt.make_workload(cfg), device="cpu")
    state, measure, metrics = sim.run(num_steps=20)
    assert metrics.collisions.shape == (20,)
    assert int(toob.pore_oob_count(state, cfg.geometry)) == 0
    for f in LEDGER:
        assert torch.isfinite(getattr(metrics, f)).all()
    assert int(metrics.wall_hits.sum()) > 0
    assert int((metrics.collisions - metrics.wall_hits).sum()) > 0
    assert int(measure.err_count) == 0
    speeds = torch.linalg.norm(state.vel, dim=-1)
    assert torch.isfinite(speeds).all() and float(speeds.max()) < 1e5
    drop = int(measure.hist_drop_count)
    assert (measure.hist.sum(dim=1) == int(measure.path_count) - drop).all()

    again, measure2, _ = sim.run(num_steps=20)
    assert torch.equal(again.pos, state.pos)
    assert torch.equal(measure2.hist, measure.hist)
