"""Port vs reference: the plain version of K7 (histogram flush) against
``ops/measure.flush_pending``, on the dense branch (capacity >= N) and the
compacted one (capacity < events, so events are dropped), its compacted
entry against ``flush_pending_compacted``, both twins in place, plus the
path bookkeeping helpers.

Tolerances: hist, path_count, hist_drop_count and the cleared staging are
exact; path_sum within reduction-order rounding (float64 1e-12 relative,
float32 1e-6 relative: a sum over ~1000 events in another order).
"""

import ctypes
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from argon_monte_carlo_tpu.ops import measure as jmeasure
from argon_monte_carlo_tpu.state import Measurements as JMeasurements
from argon_monte_carlo_tpu.state import ParticleState as JState
from argon_monte_carlo_tpu_torch import convert, kernels
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
    vals[~mask] = 0.0   # the staging's contract: unstaged rows are zero

    jm = JMeasurements.zeros(NUM_BINS, np_dtype, num_particles=N)
    jm.pending_vals, jm.pending_mask = jnp.asarray(vals), jnp.asarray(mask)
    jm.hist, jm.path_sum = jnp.asarray(hist), jnp.asarray(path_sum)
    jm.path_count = jnp.asarray(7, jnp.int32)
    jm.hist_drop_count = jnp.asarray(3, jnp.int32)
    jm = jmeasure.flush_pending(jm, NUM_BINS, HIST_HI, capacity=capacity)

    # The in-place twin is fed clones.
    tm = TMeasurements.zeros(NUM_BINS, t_dtype, num_particles=N)
    tm = dataclasses.replace(
        tm, pending_vals=torch.from_numpy(vals).clone(),
        pending_mask=torch.from_numpy(mask).clone(),
        hist=torch.from_numpy(hist).clone(),
        path_sum=torch.from_numpy(path_sum).clone(),
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


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flush_hist_compacted_plain_matches_reference(dtype):
    """event_idx is the engine's shared compaction: staged events plus
    other (dirty) particles, truncated so that some staged events are not
    listed (they count as drops), padded with n."""
    np_dtype, t_dtype = DTYPES[dtype]
    vals, mask, hist, path_sum = staged(np_dtype, seed=11)
    vals[~mask] = 0.0   # the staging's contract: unstaged rows are zero
    dirty = np.random.default_rng(12).uniform(size=N) < 0.1
    listed = np.nonzero(mask | dirty)[0][:700]
    event_idx = np.full(800, N, np.int32)
    event_idx[:listed.size] = listed
    assert (mask & ~np.isin(np.arange(N), listed)).any()

    jm = JMeasurements.zeros(NUM_BINS, np_dtype, num_particles=N)
    jm.pending_vals, jm.pending_mask = jnp.asarray(vals), jnp.asarray(mask)
    jm.hist, jm.path_sum = jnp.asarray(hist), jnp.asarray(path_sum)
    jm.path_count = jnp.asarray(7, jnp.int32)
    jm.hist_drop_count = jnp.asarray(3, jnp.int32)
    jm = jmeasure.flush_pending_compacted(jm, jnp.asarray(event_idx),
                                          NUM_BINS, HIST_HI)

    # The in-place twin is fed clones.
    tm = dataclasses.replace(
        TMeasurements.zeros(NUM_BINS, t_dtype, num_particles=N),
        pending_vals=torch.from_numpy(vals).clone(),
        pending_mask=torch.from_numpy(mask).clone(),
        hist=torch.from_numpy(hist).clone(),
        path_sum=torch.from_numpy(path_sum).clone(),
        path_count=torch.tensor(7, dtype=torch.int32),
        hist_drop_count=torch.tensor(3, dtype=torch.int32),
    )
    tm = tmeasure.flush_hist_compacted_plain(
        tm, torch.from_numpy(event_idx), NUM_BINS, HIST_HI)

    np.testing.assert_array_equal(tm.hist.numpy(), np.asarray(jm.hist))
    for f in ("path_count", "hist_drop_count"):
        assert int(getattr(tm, f)) == int(getattr(jm, f)), f
    assert int(tm.hist_drop_count) > 3
    rtol = 1e-12 if np_dtype == np.float64 else 1e-6
    np.testing.assert_allclose(tm.path_sum.numpy(), np.asarray(jm.path_sum),
                               rtol=rtol)
    assert not tm.pending_mask.any() and not tm.pending_vals.any()


def compacted_case(seed):
    """float32 staging within its contract (unstaged rows zero) and the
    engine's kind of event_idx: the staged and some other particles,
    ascending, truncated, padded with N."""
    vals, mask, hist, path_sum = staged(np.float32, seed=seed)
    vals[~mask] = 0.0
    dirty = np.random.default_rng(seed + 1).uniform(size=N) < 0.1
    listed = np.nonzero(mask | dirty)[0][:700]
    event_idx = np.full(800, N, np.int32)
    event_idx[:listed.size] = listed
    tm = dataclasses.replace(
        TMeasurements.zeros(NUM_BINS, torch.float32, num_particles=N),
        pending_vals=torch.from_numpy(vals),
        pending_mask=torch.from_numpy(mask), hist=torch.from_numpy(hist),
        path_sum=torch.from_numpy(path_sum),
        path_count=torch.tensor(7, dtype=torch.int32),
        hist_drop_count=torch.tensor(3, dtype=torch.int32),
    )
    return tm, torch.from_numpy(event_idx)


def test_flush_hist_compacted_plain_updates_in_place():
    """The twin folds into the measurements' own tensors and returns them:
    hist, path_sum, path_count and hist_drop_count updated, the staging
    cleared where it stands, and equal to a flush of clones."""
    tm, event_idx = compacted_case(seed=21)
    copy = dataclasses.replace(tm, **{f.name: getattr(tm, f.name).clone()
                                      for f in dataclasses.fields(tm)})
    given = {f.name: getattr(tm, f.name) for f in dataclasses.fields(tm)}
    events = int(tm.pending_mask.sum())
    out = tmeasure.flush_hist_compacted_plain(tm, event_idx, NUM_BINS,
                                              HIST_HI)
    for name, t in given.items():
        assert getattr(out, name) is t, name
    assert int(tm.path_count) == 7 + events > 7
    assert not tm.pending_mask.any() and not tm.pending_vals.any()
    again = tmeasure.flush_hist_compacted_plain(copy, event_idx, NUM_BINS,
                                                HIST_HI)
    for f in dataclasses.fields(tm):
        assert torch.equal(getattr(again, f.name), getattr(out, f.name))


@pytest.mark.parametrize("fault", ["unsorted", "repeated", "negative",
                                   "beyond n", "padding first"])
def test_flush_hist_compacted_plain_refuses_unsorted_event_idx(fault):
    """event_idx must ascend -- strictly increasing indices below n, then
    only the padding n -- as the kernel's binary searches need; the twin
    raises on anything else and leaves the measurements untouched."""
    tm, event_idx = compacted_case(seed=23)
    bad = event_idx.clone()
    if fault == "unsorted":
        bad[[3, 4]] = bad[[4, 3]]
    elif fault == "repeated":
        bad[5] = bad[4]
    elif fault == "negative":
        bad[0] = -1
    elif fault == "beyond n":
        bad[-1] = N + 1
    else:
        bad = torch.cat([bad[-1:], bad[:-1]])
    before = tm.pending_vals.clone()
    with pytest.raises(ValueError, match="ascend"):
        tmeasure.flush_hist_compacted_plain(tm, bad, NUM_BINS, HIST_HI)
    assert torch.equal(tm.pending_vals, before)
    tmeasure.check_event_idx(event_idx, N)


@pytest.mark.parametrize("capacity", [N, 256, 2000])
def test_flush_hist_plain_updates_in_place(capacity):
    """K7's dense twin folds into the measurements' own tensors and
    returns them, as the kernel does: the counts updated, the staging
    cleared where it stands, equal to a flush of clones; with capacity N
    every event binned, with 256 events dropped, with 2000 (N > capacity
    > events) none."""
    tm, _ = compacted_case(seed=31)
    events = int(tm.pending_mask.sum())
    assert 256 < events < 2000
    copy = dataclasses.replace(tm, **{f.name: getattr(tm, f.name).clone()
                                      for f in dataclasses.fields(tm)})
    given = {f.name: getattr(tm, f.name) for f in dataclasses.fields(tm)}
    out = tmeasure.flush_hist_plain(tm, NUM_BINS, HIST_HI, capacity)
    for name, t in given.items():
        assert getattr(out, name) is t, name
    assert int(tm.path_count) == 7 + events
    dropped = max(events - capacity, 0) if N > capacity else 0
    assert int(tm.hist_drop_count) == 3 + dropped
    assert float(tm.hist.sum() - copy.hist.sum()) == 4 * (events - dropped)
    assert not tm.pending_mask.any() and not tm.pending_vals.any()
    again = tmeasure.flush_hist_plain(copy, NUM_BINS, HIST_HI, capacity)
    for f in dataclasses.fields(tm):
        assert torch.equal(getattr(again, f.name), getattr(out, f.name))
    # A second flush of the emptied staging adds nothing but zeros.
    before = {f.name: getattr(tm, f.name).clone()
              for f in dataclasses.fields(tm)}
    tmeasure.flush_hist_plain(tm, NUM_BINS, HIST_HI, capacity)
    for name, kept in before.items():
        assert torch.equal(getattr(tm, name), kept), name


def test_flush_hist_wrapper_passes_declared_arguments(monkeypatch):
    """K7's dense entry, forced down its kernel side with the launch
    intercepted: the declared argument kinds, in place (it returns the
    measurements it was given and allocates no output), and the same
    kept scratch on a second call."""
    calls = []

    def fake_launch(name, device, *args):
        sig = kernels._SIGNATURES[name][:-1]
        assert len(args) == len(sig)
        for arg, kind in zip(args, sig):
            want = {ctypes.c_void_p: ctypes.c_void_p, ctypes.c_int: int,
                    ctypes.c_float: float}[kind]
            assert isinstance(arg, want), (arg, kind)
        calls.append((name, args[2], args[3], args[4], args[5],
                      [a.value for a in args[10:13]]))

    monkeypatch.setattr(kernels, "use_plain", lambda t: False)
    monkeypatch.setattr(kernels, "launch", fake_launch)
    tm, _ = compacted_case(seed=41)
    out = tmeasure.flush_hist(tm, NUM_BINS, HIST_HI, capacity=256)
    assert out is tm
    tmeasure.flush_hist(tm, NUM_BINS, HIST_HI)
    (name, n, cap, bins, width, scratch), second = calls
    assert (name, n, cap, bins) == ("flush_hist", N, 256, NUM_BINS)
    assert width == HIST_HI / NUM_BINS
    assert second[2] == tmeasure.FLUSH_CAPACITY and second[5] == scratch
    with pytest.raises(TypeError):
        tmeasure.flush_hist(dataclasses.replace(
            tm, pending_vals=tm.pending_vals.double()), NUM_BINS, HIST_HI)
