"""The missed-case audit (``debug_audits``) against the JAX package's.

``pore_missed_case_audit`` re-evaluates the ten wall-case predicates on the
post-wall state against the pre-drift positions.  It is held to the
reference's function exactly, on constructed (state, prior) pairs that
sit on and one ulp either side of every plane and radius the predicates
test (z = 0 only on it: one ulp off 0 is subnormal, which XLA:CPU flushes
to zero).  Then both pores, each narrow phase, run step by step through
the draw seam with the reference's uniforms, and each step's
``missed_cases`` is held exactly to the JAX engine's own sequence --
drift, ``wall_pass``, ``audit_fn`` (engine.py:152-165) -- run op by op on
the port's state of that step; 4 slabs likewise, the JAX sequence on each
slab's parked lanes (shard.py:378-405) summed over the slabs.  The audit
counts particles that the wall pass put on a wall, where r2 against R2 is
decided by the last bit: inside ``jit`` XLA:CPU contracts x*x + y*y into
an FMA, op by op it rounds as the port and the kernel do (-fmad=false),
so the reference sequence runs op by op.  On the card the temperature
pore's audit runs inside K8 (``chip_smoke.py`` holds it to this plain
audit); on the CPU the plain audit runs between the plain wall pass and
the recapture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import argon_monte_carlo_tpu as amc
import argon_monte_carlo_tpu_torch as amt
from argon_monte_carlo_tpu.config import EngineConfig as JEngine
from argon_monte_carlo_tpu.models import base as jbase
from argon_monte_carlo_tpu.parallel import shard as jshard
from argon_monte_carlo_tpu.ops import measure as jmeasure
from argon_monte_carlo_tpu.parallel.mesh import make_mesh
from argon_monte_carlo_tpu.state import Measurements as JMeasurements
from argon_monte_carlo_tpu.state import ParticleState as JState
from argon_monte_carlo_tpu_torch import convert
from argon_monte_carlo_tpu_torch.models import base as tbase
from argon_monte_carlo_tpu_torch.state import ParticleState

import test_torch_sharding as sharding

DTYPES = {"float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64)}
COUNTERS = ("path_count", "collision_count", "err_count", "overflow_count",
            "hist_drop_count", "hot_spill_count")


def critical_values(geom, physics, energized):
    """The z planes and radii the predicates of one set compare against."""
    ar = physics.argon_radius
    h, oah = geom.total_height, geom.open_air_height
    lo, hi = geom.gap_bottom, geom.gap_top
    cr_gap = geom.gap_collision_radius(physics)
    cr_pore = geom.pore_collision_radius(physics)
    zs = [0.0, h]
    rs = [geom.open_air_radius]
    if energized:
        zs += [h - oah + ar, oah - ar, hi - ar, lo + ar]
        rs += [geom.pore_coated_radius, cr_gap, cr_pore]
    else:
        zs += [h - oah, oah, hi, lo]
        rs += [geom.pore_coated_radius, geom.gap_radius]
    return zs, rs


def audit_lanes(geom, physics, energized, np_dtype, n=6000, seed=0):
    """(post, prior) positions: z on each critical plane and one ulp
    either side (a third of the lanes), radii likewise (a third), the rest
    anywhere in and a little beyond the pore."""
    rng = np.random.default_rng(seed)
    zs, rs = critical_values(geom, physics, energized)
    h = geom.total_height

    def around(values, size):
        v = np_dtype(rng.choice(np.asarray(values), size))
        step = np.where(v == 0.0, 0, rng.integers(-1, 2, size))
        out = np.where(step < 0, np.nextafter(v, np_dtype(-np.inf)), v)
        return np.where(step > 0, np.nextafter(v, np_dtype(np.inf)), out)

    def positions():
        kind = rng.integers(0, 3, n)
        z = np_dtype(rng.uniform(-0.05 * h, 1.05 * h, n))
        z = np.where(kind == 0, around(zs, n), z)
        r = np_dtype(rng.uniform(0.0, 1.05 * geom.open_air_radius, n))
        r = np.where(kind == 1, around(rs, n), r)
        theta = rng.uniform(0.0, 2 * np.pi, n)
        x = np.where(kind == 1, r, r * np.cos(theta))   # on the x axis:
        y = np.where(kind == 1, 0.0, r * np.sin(theta))  # r2 = r * r
        return np.stack([x, y, z], axis=1).astype(np_dtype)

    return positions(), positions()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("energized", [True, False],
                         ids=["energized", "specular"])
def test_audit_matches_reference_exactly(energized, dtype):
    np_dtype, torch_dtype = DTYPES[dtype]
    jcfg = amc.PoreConfig(energized=energized)
    tcfg = amt.PoreConfig(energized=energized)
    post, prior = audit_lanes(tcfg.geometry, tcfg.physics, energized,
                              np_dtype)
    zeros = np.zeros((post.shape[0], 4), np_dtype)
    jstate = JState(pos=jnp.asarray(post), vel=jnp.asarray(post),
                    paths=jnp.asarray(zeros),
                    has_collided=jnp.zeros(post.shape[0], bool))
    want = np.asarray(jbase.pore_missed_case_audit(
        jstate, jnp.asarray(prior), jcfg.geometry, jcfg.physics, energized))
    tstate = ParticleState(pos=torch.from_numpy(post),
                           vel=torch.from_numpy(post),
                           paths=torch.from_numpy(zeros),
                           has_collided=torch.zeros(post.shape[0],
                                                    dtype=torch.bool))
    got = tbase.pore_missed_case_audit(tstate, torch.from_numpy(prior),
                                       tcfg.geometry, tcfg.physics,
                                       energized)
    assert got.dtype == torch.int32 and got.shape == (10,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).all(), dict(zip(tbase.AUDIT_CASES, want.tolist()))


def reference_audit(jwl, state, run_key, i, park=None, valid=None):
    """The JAX engine's drift, wall pass and audit of step ``i`` (engine.py:
    152-165), op by op, on a port state; with ``park``, the sharded step's
    parked view of one slab (shard.py:378-405)."""
    arrays = {f: jnp.asarray(getattr(state, f).numpy())
              for f in ("pos", "vel", "paths", "has_collided")}
    jstate = JState(**arrays)
    n = jstate.pos.shape[0]
    with jax.disable_jit():
        prior = jstate.pos
        if park is not None:
            lanes = jnp.asarray(valid.numpy())[:, None]
            prior = jnp.where(lanes, prior, jnp.asarray(park))
            jstate.pos = prior
        jstate.paths = jmeasure.accumulate_drift(jstate, jwl.cfg.dt)
        jstate.pos = jstate.pos + jwl.cfg.dt * jstate.vel
        meas = JMeasurements.zeros(jwl.cfg.engine.num_bins, jnp.float64,
                                   num_particles=n)
        jstate, _, _ = jwl.wall_pass(jstate, prior, meas, key_of(run_key, i))
        if park is not None:
            jstate.pos = jnp.where(lanes, jstate.pos, jnp.asarray(park))
        return np.asarray(jwl.audit_fn(jstate, prior))


def key_of(run_key, i, shard=None):
    if shard is not None:
        run_key = jax.random.fold_in(run_key, shard)
    return jax.random.fold_in(run_key, i)


@pytest.mark.parametrize("narrowphase", ["sweep", "pairs"])
@pytest.mark.parametrize("energized", [True, False],
                         ids=["energized", "specular"])
def test_engine_missed_cases_match_reference(energized, narrowphase):
    """8 steps with debug_audits on (pairs: K=4, two rebuilds), from the
    reference's initial state, on the reference's uniforms."""
    engine = dict(dtype="float64", steps_per_epoch=4, debug_audits=True)
    if narrowphase == "pairs":
        engine.update(narrowphase="pairs", rebuild_interval=4)
    make_j = amc.temperature_pore_config if energized else amc.PoreConfig
    make_t = amt.temperature_pore_config if energized else amt.PoreConfig
    jwl = amc.make_workload(make_j(engine=JEngine(
        broadphase="cells", **engine)).scaled_to(3000))
    tsim = amt.Simulation(amt.make_workload(make_t(
        engine=amt.EngineConfig(**engine)).scaled_to(3000)), device="cpu")
    jstate, jmeas, run_key = amc.Simulation(jwl).init()
    n = jstate.pos.shape[0]
    arrays = {f: np.asarray(getattr(jstate, f))
              for f in ("pos", "vel", "paths", "has_collided")}
    arrays.update({f: np.asarray(getattr(jmeas, f)) for f in
                   ("hist", "path_sum", "pending_vals", "pending_mask")
                   + COUNTERS})
    tstate, tmeas = convert.state_from_numpy(arrays, "cpu", torch.float64)

    def draw(i):
        return torch.from_numpy(np.array(
            jax.random.uniform(key_of(run_key, i), (n, 2), jnp.float64)))

    total = 0
    for i in range(8):
        want = reference_audit(jwl, tstate, run_key, i)
        tstate, tmeas, tmet = tsim.run(num_steps=1, state=tstate,
                                       measure=tmeas, start_step=i,
                                       draw=draw)
        assert tmet.missed_cases.shape == (1, 10)
        np.testing.assert_array_equal(tmet.missed_cases[0].numpy(), want,
                                      err_msg=f"step {i}")
        total += int(want.sum())
    if energized:   # the energized pore leaves some cases each step
        assert total > 0


def test_audit_off_reports_zeros():
    cfg = amt.temperature_pore_config(engine=amt.EngineConfig(
        steps_per_epoch=3)).scaled_to(2000)
    _, _, met = amt.Simulation(amt.make_workload(cfg), device="cpu").run(
        num_steps=3)
    assert met.missed_cases.shape == (3, 10)
    assert not met.missed_cases.any()
    cube = amt.CubeConfig(num_particles_override=500, engine=amt.EngineConfig(
        broadphase="allpairs", debug_audits=True, steps_per_epoch=2))
    _, _, met = amt.Simulation(amt.make_workload(cube), device="cpu").run(
        num_steps=2)
    assert met.missed_cases.shape == (2, 10) and not met.missed_cases.any()


def test_sharded_missed_cases_match_reference():
    """4 slabs, 5 steps: the audit over each slab's parked lanes, summed
    over the slabs (the reference's psum), against the reference's
    sequence on each slab of the port's state."""
    n, steps = 3000, 5
    jcfg = sharding.reference_config(n, scaled=True, debug_audits=True)
    jsim = jshard.ShardedSimulation(amc.make_workload(jcfg),
                                    mesh=make_mesh(sharding.SLABS))
    jwl = amc.make_workload(jcfg)
    _, tsim = sharding.port_sharded(n, scaled=True, debug_audits=True)
    jstate, jmeasure, run_key = jsim.init()
    tstate, tmeasure = sharding.to_port(jstate, jmeasure)
    cap = tsim.plan.shard_capacity
    park = np.asarray(tsim.plan.park, np.float64)

    def draw(shard, i):
        return torch.from_numpy(np.array(jax.random.uniform(
            key_of(run_key, i, shard), (cap, 2), jnp.float64)))

    total = 0
    for i in range(steps):
        want = sum(
            reference_audit(jwl, st, jax.random.fold_in(run_key, s), i,
                            park=park, valid=valid)
            for s, (st, valid, _) in enumerate(tstate))
        tstate, tmeasure, tmet = tsim.run(
            num_steps=1, state=tstate, measure=tmeasure, start_step=i,
            draw=draw)
        np.testing.assert_array_equal(tmet.missed_cases[0].numpy(), want,
                                      err_msg=f"step {i}")
        total += int(want.sum())
    assert total > 0
