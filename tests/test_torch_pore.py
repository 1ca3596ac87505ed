"""Port vs reference: the specular pore (``PoreConfig(energized=False)``).

The wall pass and ``pore_v1_audit_nudge`` against the JAX functions on the
same numpy-seeded inputs, with every wall case and every nudge branch
taken; the single-card engine step by step against the JAX ``Simulation``
in float64 for both narrow phases; and the port's pairs engine against its
own sweep engine, bitwise (the reference's tests/test_pairs.py:43, :58).

The workload draws nothing after the initial state.  Tolerances: masks,
hit and error counts, per-step metrics and counters exact; state float64
within 1e-12 relative, float32 within 4 ulp of each array's magnitude (the
wall pass is sqrt and division only, which both packages round once);
path_sum within 1e-9 relative (a sum over a few events in another order).
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
from argon_monte_carlo_tpu.ops import oob as joob
from argon_monte_carlo_tpu.state import Measurements as JMeasurements
from argon_monte_carlo_tpu_torch import convert
from argon_monte_carlo_tpu_torch.ops import oob as toob
from argon_monte_carlo_tpu_torch.state import Measurements as TMeasurements

TARGET = 4000
DTYPES = {"float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64)}
COUNTERS = ("path_count", "collision_count", "err_count", "overflow_count",
            "hist_drop_count", "hot_spill_count")
EXACT_METRICS = ("collisions", "wall_hits", "oob_after_walls",
                 "oob_after_pairs")
PAIRS_METRICS = ("rebuilt", "latent_full", "teleports", "latent_research")


def assert_floats(actual, expected, dtype):
    actual, expected = np.asarray(actual), np.asarray(expected)
    eps = 4 * np.finfo(np.float32).eps if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(actual, expected, rtol=eps,
                               atol=eps * np.abs(expected).max())


def configs(dtype, **engine):
    jc = amc.PoreConfig(engine=JEngine(dtype=dtype, broadphase="cells",
                                       **engine)).scaled_to(TARGET)
    tc = amt.PoreConfig(engine=amt.EngineConfig(dtype=dtype,
                                                **engine)).scaled_to(TARGET)
    return jc, tc


def test_make_workload_dispatches_on_energized():
    """``make_workload`` takes both pores; each pore's own function
    refuses the other's config."""
    specular = amt.PoreConfig().scaled_to(TARGET)
    energized = amt.temperature_pore_config().scaled_to(TARGET)
    assert amt.make_workload(specular).cfg is specular
    assert amt.make_workload(energized).cfg is energized
    with pytest.raises(ValueError, match="energized=False"):
        amt.make_pore_workload(energized)
    with pytest.raises(ValueError, match="energized=True"):
        amt.make_temperature_pore_workload(specular)
    with pytest.raises(TypeError):
        amt.make_workload(object())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_specular_wall_pass_matches_reference(dtype):
    np_dtype, t_dtype = DTYPES[dtype]
    jc, tc = configs(dtype)
    jwl, twl = amc.make_workload(jc), amt.make_workload(tc)
    state = jwl.init_fn(jax.random.PRNGKey(11))
    n = state.num_particles
    rng = np.random.default_rng(11)
    # A long drift (40 steps' worth) so every wall case fires; paths and
    # has_collided random so the completed-path staging is exercised.
    prior = np.array(state.pos)
    vel = np.array(state.vel)
    # The gap's bases (case 5) are rarely met from a uniform fill: send 20
    # particles through each from the ledge between the pore and gap radii.
    g = jc.geometry
    k = 20
    th = rng.uniform(0, 2 * np.pi, 2 * k)
    r_mid = 0.5 * (g.pore_coated_radius + g.gap_radius)
    eps = 0.01 * (g.gap_top - g.gap_bottom)
    prior[:2 * k, 0] = r_mid * np.cos(th)
    prior[:2 * k, 1] = r_mid * np.sin(th)
    prior[:k, 2], prior[k:2 * k, 2] = g.gap_bottom + eps, g.gap_top - eps
    vel[:2 * k, :2] = rng.normal(size=(2 * k, 2)) * 1e-3
    vel[:k, 2], vel[k:2 * k, 2] = -2 * eps / (40 * jc.dt), 2 * eps / (40 * jc.dt)
    arrays = {
        "pos": (prior + 40 * jc.dt * vel).astype(np_dtype),
        "vel": vel,
        "paths": rng.uniform(0, 2e-7, (n, 4)).astype(np_dtype),
        "has_collided": rng.uniform(size=n) < 0.6,
    }
    jstate = dataclasses.replace(
        state, **{k: jnp.asarray(v) for k, v in arrays.items()})
    jm = JMeasurements.zeros(200, np_dtype, num_particles=n)
    jstate, jm, jl = jwl.wall_pass(jstate, jnp.asarray(prior), jm,
                                   jax.random.PRNGKey(5))

    tstate, _ = convert.state_from_numpy(arrays, "cpu", t_dtype)
    tm = TMeasurements.zeros(200, t_dtype, num_particles=n)
    cases = {}
    tstate, tm, tl = twl.wall_pass(tstate, torch.from_numpy(prior), tm,
                                   torch.zeros((n, 2), dtype=t_dtype), cases)

    assert len(cases) == 9
    for name, mask in cases.items():
        assert int(mask.sum()) > 0, f"case {name} took no particle"
    # Every particle in a case counts as a hit, and every handled hit ends
    # a path: it stages a completed one or ends the first, partial one.
    assert int(tl.wall_hits) == int(jl.wall_hits) == sum(
        int(m.sum()) for m in cases.values())
    assert int(tl.errs) == int(jl.errs)
    assert float(tl.momentum_z) == float(tl.energy_hot) == 0.0
    np.testing.assert_array_equal(tstate.has_collided.numpy(),
                                  np.asarray(jstate.has_collided))
    np.testing.assert_array_equal(tm.pending_mask.numpy(),
                                  np.asarray(jm.pending_mask))
    assert int(tm.pending_mask.sum()) > 0
    for f in ("pos", "vel", "paths"):
        assert_floats(getattr(tstate, f).numpy(), getattr(jstate, f),
                      np_dtype)
    assert_floats(tm.pending_vals.numpy(), jm.pending_vals, np_dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_audit_nudge_matches_reference(dtype):
    np_dtype, t_dtype = DTYPES[dtype]
    jc, tc = configs(dtype)
    g = jc.geometry
    rng = np.random.default_rng(4)
    n = 5000
    r = g.open_air_radius * 1.3 * np.sqrt(rng.uniform(size=n))
    # The ledge between the coated and the gap radius is thin: aim 200
    # particles at it, between the open-air segments.
    r[:200] = rng.uniform(g.pore_coated_radius, g.gap_radius, 200)
    th = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(-0.1, 1.1, n) * g.total_height
    z[:200] = rng.uniform(g.open_air_height,
                          g.total_height - g.open_air_height, 200)
    pos = np.stack([r * np.cos(th), r * np.sin(th), z], 1).astype(np_dtype)
    arrays = {"pos": pos, "vel": np.zeros_like(pos),
              "paths": np.zeros((n, 4), np_dtype),
              "has_collided": np.zeros(n, bool)}
    jstate = amc.state.ParticleState(**{k: jnp.asarray(v)
                                        for k, v in arrays.items()})
    tstate, _ = convert.state_from_numpy(arrays, "cpu", t_dtype)

    # Every branch is taken: below, above, beyond the open-air radius,
    # beyond the gap radius inside the pore, beyond the coated radius.
    x2y2 = pos[:, 0] ** 2 + pos[:, 1] ** 2
    inside = (z > g.open_air_height) & (z < g.total_height - g.open_air_height)
    in_gap = (z >= g.gap_bottom) & (z <= g.gap_top)
    for taken in (z < 0, z > g.total_height, x2y2 > g.open_air_radius**2,
                  (x2y2 > g.gap_radius**2) & inside
                  & (x2y2 <= g.open_air_radius**2),
                  (x2y2 > g.pore_coated_radius**2) & (x2y2 <= g.gap_radius**2)
                  & inside & ~in_gap):
        assert taken.sum() > 10

    jstate, jcount = joob.pore_v1_audit_nudge(jstate, g, jc.physics)
    tstate, tcount = toob.pore_v1_audit_nudge(tstate, tc.geometry,
                                              tc.physics)
    assert tcount.dtype == torch.int32
    assert int(tcount) == int(jcount) > 100
    np.testing.assert_array_equal(tstate.pos.numpy(), np.asarray(jstate.pos))
    # A z stray moves by 10 argon radii and stays a stray if it was
    # further out; a radial stray is on the axis.
    moved = tstate.pos.numpy()
    assert (moved[z < 0, 2] > pos[z < 0, 2]).all()
    assert (moved[x2y2 > g.open_air_radius**2, :2] == 0).all()


def start_from_reference(jsim):
    jstate, jmeas, run_key = jsim.init()
    arrays = {f: np.asarray(getattr(jstate, f))
              for f in ("pos", "vel", "paths", "has_collided")}
    arrays.update({f: np.asarray(getattr(jmeas, f)) for f in
                   ("hist", "path_sum", "pending_vals", "pending_mask")
                   + COUNTERS})
    tstate, tmeas = convert.state_from_numpy(arrays, "cpu", torch.float64)
    return jstate, jmeas, run_key, tstate, tmeas


@pytest.mark.parametrize("narrowphase", ["sweep", "pairs"])
def test_specular_engine_matches_reference_step_by_step(narrowphase):
    """12 steps; the pairs engine at K=4 rebuilds three times."""
    engine = dict(steps_per_epoch=4)
    names = EXACT_METRICS
    if narrowphase == "pairs":
        engine.update(narrowphase="pairs", rebuild_interval=4)
        names = EXACT_METRICS + PAIRS_METRICS
    jc, tc = configs("float64", **engine)
    jsim = amc.Simulation(amc.make_workload(jc))
    tsim = amt.Simulation(amt.make_workload(tc), device="cpu")
    jstate, jmeas, run_key, tstate, tmeas = start_from_reference(jsim)
    n = tstate.num_particles
    unused = torch.zeros((n, 2), dtype=torch.float64)
    pairs = 0
    for i in range(12):
        jstate, jmeas, jmet = jsim.run(num_steps=1, state=jstate,
                                       measure=jmeas, run_key=run_key,
                                       start_step=i)
        tstate, tmeas, tmet = tsim.run(num_steps=1, state=tstate,
                                       measure=tmeas, start_step=i,
                                       draw=lambda _: unused)
        for f in names:
            assert int(getattr(tmet, f)[0]) == int(
                np.asarray(getattr(jmet, f))[0]), (i, f)
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
        pairs += int(tmet.collisions[0]) - int(tmet.wall_hits[0])
        assert float(tmet.momentum_z[0]) == 0.0
    assert pairs > 0 and int(tmeas.collision_count) > pairs
    if narrowphase == "pairs":
        assert int(tmeas.overflow_count) == 0


def port_run(steps, energized, **engine):
    make = amt.temperature_pore_config if energized else amt.PoreConfig
    cfg = make(num_particles_override=3000,
               engine=amt.EngineConfig(dtype="float64", **engine))
    return amt.Simulation(amt.make_workload(cfg), device="cpu").run(
        num_steps=steps)


@pytest.mark.parametrize("energized,steps,k", [(True, 15, 5), (False, 12, 4)])
def test_pairs_matches_sweep_bitwise(energized, steps, k):
    """The reference's test_pairs.py:43 (energized: the thermal walls
    exercise the dirty re-search) and :58 (specular: a wall hit keeps the
    speed, so the walls make nothing dirty), on the port."""
    st_s, m_s, _ = port_run(steps, energized, steps_per_epoch=k)
    st_p, m_p, met = port_run(steps, energized, steps_per_epoch=k,
                              narrowphase="pairs", rebuild_interval=k)
    for f in ("pos", "vel", "paths", "has_collided"):
        assert torch.equal(getattr(st_p, f), getattr(st_s, f)), f
    for f in ("hist", "path_sum", "path_count", "collision_count"):
        assert torch.equal(getattr(m_p, f), getattr(m_s, f)), f
    assert int(m_p.collision_count) > 0
    assert int(m_p.overflow_count) == 0
    assert met.rebuilt.tolist() == ([1] + [0] * (k - 1)) * (steps // k)


def test_specular_pore_conserves_energy_single_slab():
    """A closed specular system keeps its kinetic energy, and every event
    (a wall hit, or a particle's part in a pair collision) ends a path:
    it stages a completed one or ends the first, partial one -- except
    where two events of one particle fall into one step."""
    cfg = amt.PoreConfig(num_particles_override=3000,
                         engine=amt.EngineConfig(dtype="float64",
                                                 steps_per_epoch=10))
    sim = amt.Simulation(amt.make_workload(cfg), device="cpu")
    state, meas, gen = sim.init()
    e0 = float((state.vel ** 2).sum())
    state, meas, met = sim.run(30, state=state, measure=meas, generator=gen)
    assert float((state.vel ** 2).sum()) == pytest.approx(e0, rel=1e-12)
    hits = int(met.wall_hits.sum())
    pairs = int((met.collisions - met.wall_hits).sum())
    ended = int(meas.path_count) + int(state.has_collided.sum())
    assert hits > 0 and pairs > 0
    assert 0 <= hits + 2 * pairs - ended <= 3
    assert int(meas.err_count) == 0
