"""Port vs reference: the temperature pore's wall pass with the same state
and the same per-step uniforms (drawn from the JAX key, handed to the port
as a tensor), and the recapture pass.

Tolerances: masks, hit and error counts exact.  State: float64 within
1e-12 relative; float32 within 8 ulp of each array's magnitude (the cone
draw goes through cos/sin, which PyTorch and XLA evaluate with different
polynomials, each within a couple of ulp).  Ledger sums: within
reduction-order rounding of the event count.
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


def assert_floats(actual, expected, dtype, ulps):
    actual, expected = np.asarray(actual), np.asarray(expected)
    eps = ulps * np.finfo(np.float32).eps if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(actual, expected, rtol=eps,
                               atol=eps * np.abs(expected).max())


def configs(dtype):
    jc = amc.temperature_pore_config(
        engine=JEngine(dtype=dtype)).scaled_to(TARGET)
    tc = amt.temperature_pore_config(
        engine=amt.EngineConfig(dtype=dtype)).scaled_to(TARGET)
    return jc, tc


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_wall_pass_matches_reference(dtype):
    np_dtype, t_dtype = DTYPES[dtype]
    jc, tc = configs(dtype)
    jwl, twl = amc.make_workload(jc), amt.make_workload(tc)
    state = jwl.init_fn(jax.random.PRNGKey(11))
    n = state.num_particles
    rng = np.random.default_rng(11)
    # A long drift (40 steps' worth) so every wall case fires; paths and
    # has_collided random so the completed-path staging is exercised.
    prior = np.array(state.pos)
    arrays = {
        "pos": (prior + 40 * jc.dt * np.asarray(state.vel)).astype(np_dtype),
        "vel": np.asarray(state.vel),
        "paths": rng.uniform(0, 2e-7, (n, 4)).astype(np_dtype),
        "has_collided": rng.uniform(size=n) < 0.6,
    }
    key = jax.random.PRNGKey(5)
    uniforms = np.array(jax.random.uniform(key, (n, 2), np_dtype))

    jstate = dataclasses.replace(
        state, **{k: jnp.asarray(v) for k, v in arrays.items()})
    jm = JMeasurements.zeros(200, np_dtype, num_particles=n)
    jstate, jm, jl = jwl.wall_pass(jstate, jnp.asarray(prior), jm, key)

    tstate, _ = convert.state_from_numpy(arrays, "cpu", t_dtype)
    tm = TMeasurements.zeros(200, t_dtype, num_particles=n)
    tstate, tm, tl = twl.wall_pass(tstate, torch.from_numpy(prior), tm,
                                   torch.from_numpy(uniforms))

    assert int(tl.wall_hits) == int(jl.wall_hits) > 50
    assert int(tl.errs) == int(jl.errs)
    np.testing.assert_array_equal(tstate.has_collided.numpy(),
                                  np.asarray(jstate.has_collided))
    np.testing.assert_array_equal(tm.pending_mask.numpy(),
                                  np.asarray(jm.pending_mask))
    for f in ("pos", "vel", "paths"):
        assert_floats(getattr(tstate, f).numpy(), getattr(jstate, f),
                      np_dtype, ulps=8)
    assert_floats(tm.pending_vals.numpy(), jm.pending_vals, np_dtype, ulps=8)
    hits = int(tl.wall_hits)
    for f in ("momentum_z", "energy_hot", "energy_cold"):
        a, b = float(getattr(tl, f)), float(getattr(jl, f))
        assert a == pytest.approx(b, rel=hits * np.finfo(np_dtype).eps * 8,
                                  abs=1e-30), f


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_recapture_matches_reference(dtype):
    np_dtype, t_dtype = DTYPES[dtype]
    jc, tc = configs(dtype)
    g = jc.geometry
    rng = np.random.default_rng(4)
    n = 5000
    r = g.open_air_radius * 1.3 * np.sqrt(rng.uniform(size=n))
    th = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(-0.1, 1.1, n) * g.total_height
    pos = np.stack([r * np.cos(th), r * np.sin(th), z], 1).astype(np_dtype)
    arrays = {"pos": pos, "vel": np.zeros_like(pos),
              "paths": np.zeros((n, 4), np_dtype),
              "has_collided": np.zeros(n, bool)}
    jstate = amc.state.ParticleState(**{k: jnp.asarray(v)
                                        for k, v in arrays.items()})
    tstate, _ = convert.state_from_numpy(arrays, "cpu", t_dtype)

    assert int(toob.pore_oob_count(tstate, tc.geometry)) == int(
        joob.pore_oob_count(jstate, g)) > 100
    inset = 0.5 * g.open_air_height
    jstate, jcount = joob.pore_recapture(jstate, g, inset)
    tstate, tcount = toob.pore_recapture(tstate, tc.geometry, inset)
    assert int(tcount) == int(jcount) > 100
    np.testing.assert_array_equal(tstate.pos.numpy(), np.asarray(jstate.pos))
    assert int(toob.pore_oob_count(tstate, tc.geometry)) == 0
