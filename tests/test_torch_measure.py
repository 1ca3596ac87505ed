"""Port vs reference: the plain version of K7 (histogram flush) against
``ops/measure.flush_pending``, on the dense branch (capacity >= N) and the
compacted one (capacity < events, so events are dropped), plus the path
bookkeeping helpers.

Tolerances: hist, path_count, hist_drop_count and the cleared staging are
exact; path_sum within reduction-order rounding (float64 1e-12 relative,
float32 1e-6 relative: a sum over ~1000 events in another order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from argon_monte_carlo_tpu.ops import measure as jmeasure
from argon_monte_carlo_tpu.state import Measurements as JMeasurements
from argon_monte_carlo_tpu.state import ParticleState as JState
from argon_monte_carlo_tpu_torch import convert
from argon_monte_carlo_tpu_torch.ops import measure as tmeasure
from argon_monte_carlo_tpu_torch.state import Measurements as TMeasurements

NUM_BINS, HIST_HI, N = 200, 1e-6, 4096
DTYPES = {"float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64)}


def staged(np_dtype, seed):
    rng = np.random.default_rng(seed)
    # Mostly in range, some beyond hist_hi (last bin), some exactly 0.
    vals = rng.exponential(2e-7, (N, 4)).astype(np_dtype)
    vals[::97] = 0.0
    mask = rng.uniform(size=N) < 0.25
    hist = rng.integers(0, 50, (4, NUM_BINS + 1)).astype(np.float32)
    path_sum = rng.uniform(0, 1e-3, 4).astype(np_dtype)
    return vals, mask, hist, path_sum


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("capacity", [N, 16384, 256])
def test_flush_hist_plain_matches_reference(dtype, capacity):
    np_dtype, t_dtype = DTYPES[dtype]
    vals, mask, hist, path_sum = staged(np_dtype, seed=capacity)

    jm = JMeasurements.zeros(NUM_BINS, np_dtype, num_particles=N)
    jm.pending_vals, jm.pending_mask = jnp.asarray(vals), jnp.asarray(mask)
    jm.hist, jm.path_sum = jnp.asarray(hist), jnp.asarray(path_sum)
    jm.path_count = jnp.asarray(7, jnp.int32)
    jm.hist_drop_count = jnp.asarray(3, jnp.int32)
    jm = jmeasure.flush_pending(jm, NUM_BINS, HIST_HI, capacity=capacity)

    tm = TMeasurements.zeros(NUM_BINS, t_dtype, num_particles=N)
    tm = dataclasses.replace(
        tm, pending_vals=torch.from_numpy(vals),
        pending_mask=torch.from_numpy(mask), hist=torch.from_numpy(hist),
        path_sum=torch.from_numpy(path_sum),
        path_count=torch.tensor(7, dtype=torch.int32),
        hist_drop_count=torch.tensor(3, dtype=torch.int32),
    )
    tm = tmeasure.flush_hist_plain(tm, NUM_BINS, HIST_HI, capacity=capacity)

    assert tm.hist.dtype == torch.float32
    np.testing.assert_array_equal(tm.hist.numpy(), np.asarray(jm.hist))
    assert int(tm.path_count) == int(jm.path_count)
    assert int(tm.hist_drop_count) == int(jm.hist_drop_count)
    if capacity < mask.sum():
        assert int(tm.hist_drop_count) == 3 + mask.sum() - capacity
    rtol = 1e-12 if np_dtype == np.float64 else 1e-6
    np.testing.assert_allclose(tm.path_sum.numpy(), np.asarray(jm.path_sum),
                               rtol=rtol)
    assert not tm.pending_mask.any() and not tm.pending_vals.any()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_path_bookkeeping_matches_reference(dtype):
    np_dtype, t_dtype = DTYPES[dtype]
    rng = np.random.default_rng(5)
    arrays = {
        "pos": rng.uniform(0, 1e-7, (N, 3)).astype(np_dtype),
        "vel": (rng.normal(size=(N, 3)) * 300.0).astype(np_dtype),
        "paths": rng.uniform(0, 2e-7, (N, 4)).astype(np_dtype),
        "has_collided": rng.uniform(size=N) < 0.5,
    }
    t = rng.uniform(-1e-12, 1e-12, N).astype(np_dtype)
    mask = rng.uniform(size=N) < 0.3
    dt = 3.7e-12

    jstate = JState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tstate, _ = convert.state_from_numpy(arrays, "cpu", t_dtype)
    eps = 4 * np.finfo(np_dtype).eps
    np.testing.assert_allclose(
        tmeasure.accumulate_drift(tstate, dt).numpy(),
        np.asarray(jmeasure.accumulate_drift(jstate, dt)), rtol=eps)

    jm = JMeasurements.zeros(NUM_BINS, np_dtype, num_particles=N)
    jm = jmeasure.record_completed(jm, jstate.paths, jstate.has_collided,
                                   jstate.vel, jnp.asarray(t),
                                   jnp.asarray(mask), NUM_BINS, HIST_HI)
    tm = TMeasurements.zeros(NUM_BINS, t_dtype, num_particles=N)
    tm = tmeasure.record_completed(tm, tstate.paths, tstate.has_collided,
                                   tstate.vel, torch.from_numpy(t),
                                   torch.from_numpy(mask))
    np.testing.assert_array_equal(tm.pending_mask.numpy(),
                                  np.asarray(jm.pending_mask))
    np.testing.assert_allclose(tm.pending_vals.numpy(),
                               np.asarray(jm.pending_vals), rtol=eps,
                               atol=eps * 2e-7)

    for zero_residual in (False, True):
        js = jmeasure.end_paths(dataclasses.replace(jstate),
                                jnp.asarray(mask), jnp.asarray(t),
                                jstate.vel, zero_residual)
        ts = tmeasure.end_paths(tstate, torch.from_numpy(mask),
                                torch.from_numpy(t), tstate.vel,
                                zero_residual)
        np.testing.assert_allclose(ts.paths.numpy(), np.asarray(js.paths),
                                   rtol=eps)
        np.testing.assert_array_equal(ts.has_collided.numpy(),
                                      np.asarray(js.has_collided))
