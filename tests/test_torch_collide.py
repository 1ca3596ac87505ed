"""Port vs reference: the plain versions of K2 (cell binning and table), K9
(partner sweep) and K10 (impulse exchange) against the JAX functions on
the same numpy-seeded inputs.

Tolerances: integer outputs (cell ids, table, pslot, overflow, partners,
masks, counts) are exact.  Floats: float64 within 1e-12 relative, float32
within 4 ulp of the array's magnitude (both packages round every
operation the same way; the bound leaves room for the XLA CPU compiler's
own choices).

The z-slab engine's arguments -- ``valid`` (K2, K9), ``ids`` and
``cell_window`` (K9), ``local_mask`` (K10) -- are held to the same JAX
functions called with them, on lanes that hold duplicates with one id (a
particle beside its own ghost copy), padding and a window over part of the
grid.
"""

import ctypes
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import argon_monte_carlo_tpu as amc
import argon_monte_carlo_tpu_torch as amt
from argon_monte_carlo_tpu import config as jcfg
from argon_monte_carlo_tpu.ops import collide as jcollide
from argon_monte_carlo_tpu.state import Measurements as JMeasurements
from argon_monte_carlo_tpu.state import ParticleState as JState
from argon_monte_carlo_tpu_torch import convert
from argon_monte_carlo_tpu_torch.ops import collide as tcollide

TARGET = 4000
DTYPES = {"float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64)}


def assert_floats(actual, expected, dtype):
    actual, expected = np.asarray(actual), np.asarray(expected)
    if dtype == np.float64:
        np.testing.assert_allclose(actual, expected, rtol=1e-12,
                                   atol=1e-12 * np.abs(expected).max())
    else:
        eps = 4 * np.finfo(np.float32).eps
        np.testing.assert_allclose(actual, expected, rtol=eps,
                                   atol=eps * np.abs(expected).max())


def pore_setup(capacity=None):
    cfg = amc.temperature_pore_config().scaled_to(TARGET)
    n, vol = cfg.num_molecules, cfg.geometry.volume
    eng = jcfg.EngineConfig(cell_capacity=capacity)
    size = jcfg.cell_size_for(eng, cfg.physics, n, vol)
    cap = jcfg.cell_capacity_for(eng, cfg.physics, n, vol)
    return cfg, jcollide.grid_for_pore(cfg.geometry, size, cap)


def grids(host_grid, np_dtype, t_dtype):
    jgrid = jcollide.DeviceGrid.from_grid(host_grid, np_dtype,
                                          packed_layers=True)
    tgrid = convert.grid_from_numpy(
        {f: getattr(host_grid, f) for f in
         ("nx", "layer_base", "half_extent", "neighbors", "cell_size",
          "z_lo", "nz", "num_cells", "capacity")},
        device="cpu", dtype=t_dtype,
    )
    return jgrid, tgrid


def clustered_positions(cfg, rng, n_base=3000, n_pairs=500, n_triples=60,
                        n_strays=20):
    """Uniform fill of the pore's bounding cylinder, plus close pairs and
    triples (so the sweep finds partners) and strays outside the grid."""
    g = cfg.geometry
    cr = cfg.physics.collision_range
    r = g.open_air_radius * np.sqrt(rng.uniform(size=n_base))
    th = rng.uniform(0, 2 * np.pi, n_base)
    base = np.stack([r * np.cos(th), r * np.sin(th),
                     rng.uniform(0, g.total_height, n_base)], axis=1)

    def near(anchor, k):
        d = rng.normal(size=(k, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return anchor + d * cr * rng.uniform(0.3, 0.99, (k, 1))

    a = base[rng.choice(n_base, n_pairs, replace=False)]
    t = base[rng.choice(n_base, n_triples, replace=False)]
    strays = np.concatenate([
        base[:n_strays] * [1, 1, 0] - [0, 0, 3e-9],
        base[n_strays:2 * n_strays] * [3, 3, 1],
        base[2 * n_strays:3 * n_strays] + [0, 0, g.total_height],
    ])
    pos = np.concatenate([base, near(a, n_pairs), near(t, n_triples),
                          near(t, n_triples), strays])
    return pos[rng.permutation(pos.shape[0])]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("capacity", [None, 4])
def test_bin_and_table_plain_matches_reference(dtype, capacity):
    np_dtype, t_dtype = DTYPES[dtype]
    cfg, host_grid = pore_setup(capacity)
    jgrid, tgrid = grids(host_grid, np_dtype, t_dtype)
    pos = clustered_positions(cfg, np.random.default_rng(1)).astype(np_dtype)

    cid_j = jcollide.assign_cells(jnp.asarray(pos), jgrid)
    table_j, overflow_j, pslot_j = jcollide.build_cell_table(cid_j, jgrid)
    cid_t, table_t, pslot_t, overflow_t = tcollide.bin_and_table_plain(
        torch.from_numpy(pos), tgrid)

    for got, want in ((cid_t, cid_j), (table_t, table_j),
                      (pslot_t, pslot_j), (overflow_t, overflow_j)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if capacity == 4:
        assert int(overflow_t) > 0  # full cells: the stable order decides


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("capacity", [None, 4])
def test_partner_sweep_plain_matches_reference(dtype, capacity):
    np_dtype, t_dtype = DTYPES[dtype]
    cfg, host_grid = pore_setup(capacity)
    jgrid, tgrid = grids(host_grid, np_dtype, t_dtype)
    pos = clustered_positions(cfg, np.random.default_rng(2)).astype(np_dtype)
    radius = cfg.physics.collision_range

    partner_j, _ = jcollide.cell_partner_search(jnp.asarray(pos), jgrid,
                                                radius)
    pos_t = torch.from_numpy(pos)
    _, table, pslot, _ = tcollide.bin_and_table_plain(pos_t, tgrid)
    partner_t = tcollide.partner_sweep_plain(pos_t, table, pslot, tgrid,
                                             radius, chunk=1024)
    assert partner_t.dtype == torch.int32
    np.testing.assert_array_equal(partner_t.numpy(), np.asarray(partner_j))
    assert int((partner_t >= 0).sum()) > 500


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_resolve_pairs_plain_matches_reference(dtype):
    np_dtype, t_dtype = DTYPES[dtype]
    cfg, host_grid = pore_setup()
    jgrid, tgrid = grids(host_grid, np_dtype, t_dtype)
    rng = np.random.default_rng(3)
    pos = clustered_positions(cfg, rng).astype(np_dtype)
    n = pos.shape[0]
    arrays = {
        "pos": pos,
        "vel": (rng.normal(size=(n, 3)) * 300.0).astype(np_dtype),
        "paths": rng.uniform(0, 2e-7, (n, 4)).astype(np_dtype),
        "has_collided": rng.uniform(size=n) < 0.7,
    }
    pending_vals = rng.uniform(0, 1e-6, (n, 4)).astype(np_dtype)
    pending_mask = rng.uniform(size=n) < 0.1
    cr = cfg.physics.collision_range
    partner, _ = jcollide.cell_partner_search(jnp.asarray(pos), jgrid, cr)

    jstate = JState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jmeas = JMeasurements.zeros(200, np_dtype, num_particles=n)
    jmeas.pending_vals = jnp.asarray(pending_vals)
    jmeas.pending_mask = jnp.asarray(pending_mask)
    jstate, jmeas, ncol_j, _ = jcollide.resolve_collisions(
        jstate, jmeas, partner, cr, cfg.physics.mass, 200, 1e-6)

    tstate, _ = convert.state_from_numpy(arrays, "cpu", t_dtype)
    tmeas = amt.state.Measurements.zeros(200, t_dtype, num_particles=n)
    tmeas = dataclasses.replace(
        tmeas, pending_vals=torch.from_numpy(pending_vals),
        pending_mask=torch.from_numpy(pending_mask))
    tstate, tmeas, ncol_t = tcollide.resolve_pairs_plain(
        tstate, tmeas, torch.from_numpy(np.array(partner)), cr)

    assert int(ncol_t) == int(ncol_j) > 200
    for f in ("pos", "vel", "paths"):
        assert_floats(getattr(tstate, f).numpy(), getattr(jstate, f),
                      np_dtype)
    np.testing.assert_array_equal(tstate.has_collided.numpy(),
                                  np.asarray(jstate.has_collided))
    np.testing.assert_array_equal(tmeas.pending_mask.numpy(),
                                  np.asarray(jmeas.pending_mask))
    assert_floats(tmeas.pending_vals.numpy(), jmeas.pending_vals, np_dtype)


def test_wrappers_choose_by_device():
    """CPU tensors take the plain version (no kernel launch); a device that
    is neither the CPU nor CUDA raises instead of falling back."""
    _, host_grid = pore_setup()
    _, tgrid = grids(host_grid, np.float32, torch.float32)
    pos = torch.zeros((8, 3), dtype=torch.float32)
    before = dict(amt.kernels.launch_counts)
    out = tcollide.bin_and_table(pos, tgrid)
    for got, want in zip(out, tcollide.bin_and_table_plain(pos, tgrid)):
        assert torch.equal(got, want)
    assert dict(amt.kernels.launch_counts) == before
    with pytest.raises(ValueError, match="plain version runs on the CPU"):
        tcollide.bin_and_table(pos.to("meta"), tgrid)


# --------------------------------------------------------------------------
# The z-slab engine's arguments
# --------------------------------------------------------------------------


def slab_lanes(cfg, rng, np_dtype, copies=300):
    """Lanes as a slab's pair phase sees them: particles, ``copies`` of
    them repeated at the same place under the same id (what a ghost of
    oneself would be), ids that are no lane indices, and a tenth of the
    lanes holding nothing, parked far away."""
    base = clustered_positions(cfg, rng)
    pos = np.concatenate([base, base[:copies]]).astype(np_dtype)
    n = pos.shape[0]
    ids = rng.permutation(base.shape[0]).astype(np.int32) + 7
    ids = np.concatenate([ids, ids[:copies]])
    valid = rng.uniform(size=n) > 0.1
    pos[~valid] = 1e9
    return pos, ids, valid


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("capacity", [None, 4])
def test_bin_and_table_valid_matches_reference(dtype, capacity):
    np_dtype, t_dtype = DTYPES[dtype]
    cfg, host_grid = pore_setup(capacity)
    jgrid, tgrid = grids(host_grid, np_dtype, t_dtype)
    pos, _, valid = slab_lanes(cfg, np.random.default_rng(5), np_dtype)

    cid_j = jcollide.assign_cells(jnp.asarray(pos), jgrid, jnp.asarray(valid))
    table_j, overflow_j, pslot_j = jcollide.build_cell_table(cid_j, jgrid)
    cid_t, table_t, pslot_t, overflow_t = tcollide.bin_and_table_plain(
        torch.from_numpy(pos), tgrid, valid=torch.from_numpy(valid))

    dummy = host_grid.num_cells * host_grid.capacity
    np.testing.assert_array_equal(cid_t.numpy(), np.asarray(cid_j))
    np.testing.assert_array_equal(table_t.numpy(), np.asarray(table_j))
    assert int(overflow_t) == int(overflow_j)
    # An invalid lane takes no slot: the reference leaves its rank in the
    # dummy row (num_cells * cap + rank), which reads the same.
    np.testing.assert_array_equal(pslot_t.numpy(),
                                  np.minimum(np.asarray(pslot_j), dummy))
    assert (cid_t.numpy()[~valid] == host_grid.num_cells).all()
    assert (pslot_t.numpy()[~valid] == dummy).all()
    assert (int(overflow_t) > 0) == (capacity == 4)
    # Without the argument the far lanes would be binned and counted.
    assert not torch.equal(
        tcollide.bin_and_table_plain(torch.from_numpy(pos), tgrid)[0], cid_t)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("window", [None, (0.3, 0.4)],
                         ids=["whole-grid", "window"])
def test_partner_sweep_slab_arguments_match_reference(dtype, window):
    np_dtype, t_dtype = DTYPES[dtype]
    cfg, host_grid = pore_setup()
    jgrid, tgrid = grids(host_grid, np_dtype, t_dtype)
    pos, ids, valid = slab_lanes(cfg, np.random.default_rng(6), np_dtype)
    radius = cfg.physics.collision_range
    if window is not None:
        cells = host_grid.num_cells
        window = (int(window[0] * cells), int(window[1] * cells))

    partner_j, overflow_j = jcollide.cell_partner_search(
        jnp.asarray(pos), jgrid, radius, ids=jnp.asarray(ids),
        valid=jnp.asarray(valid), cell_window=window)
    pos_t, ids_t, valid_t = (torch.from_numpy(a) for a in (pos, ids, valid))
    _, table, pslot, overflow_t = tcollide.bin_and_table_plain(
        pos_t, tgrid, valid=valid_t)
    partner_t = tcollide.partner_sweep_plain(
        pos_t, table, pslot, tgrid, radius, chunk=1024, ids=ids_t,
        valid=valid_t, cell_window=window)
    np.testing.assert_array_equal(partner_t.numpy(), np.asarray(partner_j))
    assert int(overflow_t) == int(overflow_j)
    got = partner_t.numpy()
    assert (got >= 0).sum() > (100 if window else 500)
    assert (got[~valid] == -1).all()
    # No lane pairs with a lane of its own id, though its copy sits at
    # distance zero; with lane indices as ids the copies would pair.
    has = got >= 0
    assert (ids[got[has]] != ids[has]).all()
    by_index = tcollide.partner_sweep_plain(pos_t, table, pslot, tgrid,
                                            radius, chunk=1024)
    assert (ids[by_index.numpy()[has]] == ids[has]).any()
    if window:
        cell = pslot.numpy() // host_grid.capacity
        outside = (cell < window[0]) | (cell >= window[0] + window[1])
        assert (got[outside] == -1).all() and (by_index.numpy()[outside]
                                               >= 0).any()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_resolve_pairs_local_mask_matches_reference(dtype):
    np_dtype, t_dtype = DTYPES[dtype]
    cfg, host_grid = pore_setup()
    jgrid, tgrid = grids(host_grid, np_dtype, t_dtype)
    rng = np.random.default_rng(7)
    pos, ids, valid = slab_lanes(cfg, rng, np_dtype)
    n = pos.shape[0]
    local = valid & (rng.uniform(size=n) < 0.7)
    arrays = {
        "pos": pos,
        "vel": (rng.normal(size=(n, 3)) * 300.0).astype(np_dtype),
        "paths": rng.uniform(0, 2e-7, (n, 4)).astype(np_dtype),
        "has_collided": rng.uniform(size=n) < 0.7,
    }
    pending_vals = rng.uniform(0, 1e-6, (n, 4)).astype(np_dtype)
    pending_mask = rng.uniform(size=n) < 0.1
    cr = cfg.physics.collision_range
    partner, _ = jcollide.cell_partner_search(
        jnp.asarray(pos), jgrid, cr, ids=jnp.asarray(ids),
        valid=jnp.asarray(valid))

    jstate = JState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jmeas = JMeasurements.zeros(200, np_dtype, num_particles=n)
    jmeas.pending_vals = jnp.asarray(pending_vals)
    jmeas.pending_mask = jnp.asarray(pending_mask)
    jstate, jmeas, count_j, ok_j = jcollide.resolve_collisions(
        jstate, jmeas, partner, cr, cfg.physics.mass, 200, 1e-6,
        local_mask=jnp.asarray(local))

    tstate, _ = convert.state_from_numpy(arrays, "cpu", t_dtype)
    tmeas = dataclasses.replace(
        amt.state.Measurements.zeros(200, t_dtype, num_particles=n),
        pending_vals=torch.from_numpy(pending_vals),
        pending_mask=torch.from_numpy(pending_mask))
    before = tmeas.collision_count.clone()
    tstate, tmeas, count_t, ok_t = tcollide.resolve_pairs_plain(
        tstate, tmeas, torch.from_numpy(np.array(partner)), cr,
        local_mask=torch.from_numpy(local))

    ok = ok_t.numpy()
    np.testing.assert_array_equal(ok, np.asarray(ok_j))
    assert int(count_t) == int(count_j) == int((ok & local).sum()) > 100
    assert (ok & ~local).sum() > 20      # ghosts matched, and left alone
    assert torch.equal(tmeas.collision_count, before)
    for f in ("pos", "vel", "paths"):
        assert_floats(getattr(tstate, f).numpy(), getattr(jstate, f),
                      np_dtype)
        np.testing.assert_array_equal(getattr(tstate, f).numpy()[~local],
                                      arrays[f][~local])
    np.testing.assert_array_equal(tstate.has_collided.numpy(),
                                  np.asarray(jstate.has_collided))
    np.testing.assert_array_equal(tmeas.pending_mask.numpy(),
                                  np.asarray(jmeas.pending_mask))
    assert_floats(tmeas.pending_vals.numpy(), jmeas.pending_vals, np_dtype)


@pytest.mark.parametrize("slab", [False, True], ids=["plain", "slab"])
def test_sweep_wrappers_pass_declared_arguments(monkeypatch, slab):
    """K2, K9 and K10, forced down their kernel side with the launch
    intercepted, pass exactly the declared argument kinds: null pointers
    and the whole grid as window without the z-slab arguments, the
    tensors and the window with them."""
    calls = {}

    def fake_launch(name, device, *args):
        calls[name] = args
        sig = amt.kernels._SIGNATURES[name][:-1]  # the stream is launch's
        assert len(args) == len(sig), name
        for arg, kind in zip(args, sig):
            want = {ctypes.c_void_p: ctypes.c_void_p, ctypes.c_int: int,
                    ctypes.c_float: float}[kind]
            assert isinstance(arg, want), (name, arg, kind)

    cfg, host_grid = pore_setup()
    _, tgrid = grids(host_grid, np.float32, torch.float32)
    pos, ids, valid = slab_lanes(cfg, np.random.default_rng(8), np.float32)
    n = pos.shape[0]
    pos_t, ids_t, valid_t = (torch.from_numpy(a) for a in (pos, ids, valid))
    state = amt.state.ParticleState.zeros(n)
    state.pos = pos_t
    meas = amt.state.Measurements.zeros(200, torch.float32, num_particles=n)
    table = torch.zeros((tgrid.num_cells + 1, tgrid.capacity),
                        dtype=torch.int32)
    pslot = torch.zeros(n, dtype=torch.int32)
    monkeypatch.setattr(amt.kernels, "use_plain", lambda t: False)
    monkeypatch.setattr(amt.kernels, "launch", fake_launch)
    cr = cfg.physics.collision_range
    if slab:
        tcollide.bin_and_table(pos_t, tgrid, valid=valid_t)
        tcollide.partner_sweep(pos_t, table, pslot, tgrid, cr, ids=ids_t,
                               valid=valid_t, cell_window=(100, 50))
        out = tcollide.resolve_pairs(state, meas, pslot, cr,
                                     local_mask=valid_t)
        assert len(out) == 4 and out[3].shape == (n,)
    else:
        tcollide.bin_and_table(pos_t, tgrid)
        tcollide.partner_sweep(pos_t, table, pslot, tgrid, cr)
        assert len(tcollide.resolve_pairs(state, meas, pslot, cr)) == 3
    given = (lambda a: a.value is not None) if slab else (
        lambda a: a.value is None)
    assert given(calls["bin_and_table"][1])
    assert all(given(a) for a in calls["partner_sweep"][4:6])
    assert calls["partner_sweep"][9:11] == (
        (100, 50) if slab else (0, tgrid.num_cells))
    assert given(calls["resolve_pairs"][7])
    assert given(calls["resolve_pairs"][-2])
