"""The slice as a whole: the port's sweep engine against the JAX
``Simulation`` (sweep narrow phase, cells broad phase, exact flush).

Both start from the reference's initial state (carried across with
``convert.state_from_numpy``) and the port gets the reference's per-step
uniforms through ``draw``, so the trajectories are the same up to rounding.
Run with the exact flush (every step) and a 3-step flush window.
Tolerances, checked after every step: per-step collisions, wall hits,
recaptures, the histogram, the staging mask, path_count and every counter
exact; state within 1e-12 relative (float64); ledger and path_sum within
1e-9 relative (sums over a few events taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import argon_monte_carlo_tpu as amc
import argon_monte_carlo_tpu_torch as amt
from argon_monte_carlo_tpu.config import EngineConfig as JEngine
from argon_monte_carlo_tpu_torch import convert
from argon_monte_carlo_tpu_torch.ops import oob as toob

STEPS = 10
EXACT_METRICS = ("collisions", "wall_hits", "oob_after_walls",
                 "oob_after_pairs")
LEDGER = ("momentum_z", "energy_hot", "energy_cold")
COUNTERS = ("path_count", "collision_count", "err_count", "overflow_count",
            "hist_drop_count")


@pytest.mark.parametrize("flush_interval", [1, 3])
def test_sweep_engine_matches_reference_step_by_step(flush_interval):
    jcfg = amc.temperature_pore_config(engine=JEngine(
        broadphase="cells", dtype="float64",
        hist_flush_interval=flush_interval)).scaled_to(4000)
    tcfg = amt.temperature_pore_config(engine=amt.EngineConfig(
        dtype="float64", hist_flush_interval=flush_interval)).scaled_to(4000)
    jsim = amc.Simulation(amc.make_workload(jcfg))
    tsim = amt.Simulation(amt.make_workload(tcfg), device="cpu")

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

    pair_collisions = 0
    for i in range(STEPS):
        jstate, jmeas, jmet = jsim.run(num_steps=1, state=jstate,
                                       measure=jmeas, run_key=run_key,
                                       start_step=i)
        tstate, tmeas, tmet = tsim.run(num_steps=1, state=tstate,
                                       measure=tmeas, start_step=i,
                                       draw=draw)
        for f in EXACT_METRICS:
            want = int(np.asarray(getattr(jmet, f))[0])
            assert tmet_value(tmet, f) == want, (i, f)
        for f in LEDGER:
            assert float(getattr(tmet, f)[0]) == pytest.approx(
                float(np.asarray(getattr(jmet, f))[0]), rel=1e-9, abs=1e-35)
        for f in COUNTERS:
            assert int(getattr(tmeas, f)) == int(getattr(jmeas, f)), (i, f)
        np.testing.assert_array_equal(tmeas.hist.numpy(),
                                      np.asarray(jmeas.hist))
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
        pair_collisions += tmet_value(tmet, "collisions") - tmet_value(
            tmet, "wall_hits")
    assert pair_collisions > 0
    assert int(tmeas.path_count) > 0


def tmet_value(metrics, field):
    return int(getattr(metrics, field)[0])


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
