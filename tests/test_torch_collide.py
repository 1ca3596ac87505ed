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
    count = torch.zeros((), dtype=torch.int32)
    tstate, tmeas, ncol_t = tcollide.resolve_pairs_plain(
        tstate, tmeas, torch.from_numpy(np.array(partner)), cr, count=count)

    assert ncol_t is count
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


def slab_lanes(cfg, rng, np_dtype, copies=300, id_order=False):
    """Lanes as a slab's pair phase sees them: particles, ``copies`` of
    them repeated at the same place under the same id (what a ghost of
    oneself would be), ids that are no lane indices, and a tenth of the
    lanes holding nothing, parked far away.  With ``id_order`` the lanes
    are put in id order (copies side by side), where K9's lowest id is
    also the reference's lowest lane."""
    base = clustered_positions(cfg, rng)
    pos = np.concatenate([base, base[:copies]]).astype(np_dtype)
    n = pos.shape[0]
    ids = rng.permutation(base.shape[0]).astype(np.int32) + 7
    ids = np.concatenate([ids, ids[:copies]])
    valid = rng.uniform(size=n) > 0.1
    pos[~valid] = 1e9
    if id_order:
        perm = np.argsort(ids, kind="stable")
        pos, ids, valid = pos[perm], ids[perm], valid[perm]
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
    # K9 orders candidates by id, the reference by lane: on lanes in id
    # order the two agree (test_torch_sharded_cube.py holds the id order on
    # lanes in any order).
    pos, ids, valid = slab_lanes(cfg, np.random.default_rng(6), np_dtype,
                                 id_order=True)
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
        count=torch.zeros((), dtype=torch.int32),
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


def hard_partners(partner, ok, rng, local=None):
    """The partner array with the cases an in-place K10 must get right: a
    chain k -> i while i <-> j (k a lane without a partner pointed at a
    lane of a matched pair), self-partners (not a pair), and, with
    ``local``, matched pairs split between a local and a ghost lane each
    way.  Returns (partner, local, the lanes of each case)."""
    partner = partner.copy()
    lone = rng.permutation(np.flatnonzero(partner < 0))
    ends = np.flatnonzero(ok)
    chain, selfish = lone[:40], lone[40:80]
    partner[chain] = rng.choice(ends, 40, replace=False)
    partner[selfish] = selfish
    split = None
    if local is not None:
        local = local.copy()
        lo = np.unique(np.minimum(ends, partner[ends]))
        lo = lo[local[lo] & local[partner[lo]]]
        local[partner[lo[:30]]] = False   # the higher lane a ghost
        local[lo[30:60]] = False          # the lower lane a ghost
        split = np.concatenate([lo[:60], partner[lo[:60]]])
    return partner, local, dict(chain=chain, selfish=selfish, split=split)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("slab", [False, True], ids=["plain", "slab"])
def test_resolve_pairs_plain_in_place_matches_reference(dtype, slab):
    """The in-place twin on clones of its inputs against the JAX
    resolve_collisions, with a chain k -> i <-> j, self-partners and (on a
    slab) pairs split across a local and a ghost lane: the tensors given
    are the tensors returned, the lanes not applied to keep their rows,
    and the count grows from what it held."""
    np_dtype, t_dtype = DTYPES[dtype]
    cfg, host_grid = pore_setup()
    jgrid, _ = grids(host_grid, np_dtype, t_dtype)
    rng = np.random.default_rng(11)
    if slab:
        pos, ids, valid = slab_lanes(cfg, rng, np_dtype)
        kw = dict(ids=jnp.asarray(ids), valid=jnp.asarray(valid))
        local = valid & (rng.uniform(size=pos.shape[0]) < 0.8)
    else:
        pos = clustered_positions(cfg, rng).astype(np_dtype)
        kw, local = {}, None
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
    partner, _ = jcollide.cell_partner_search(jnp.asarray(pos), jgrid, cr,
                                              **kw)

    def reference(partner, local):
        jstate = JState(**{k: jnp.asarray(v) for k, v in arrays.items()})
        jmeas = JMeasurements.zeros(200, np_dtype, num_particles=n)
        jmeas.pending_vals = jnp.asarray(pending_vals)
        jmeas.pending_mask = jnp.asarray(pending_mask)
        return jcollide.resolve_collisions(
            jstate, jmeas, jnp.asarray(partner), cr, cfg.physics.mass, 200,
            1e-6, local_mask=None if local is None else jnp.asarray(local))

    ok0 = np.asarray(reference(np.asarray(partner), local)[3])
    partner, local, lanes = hard_partners(np.asarray(partner), ok0, rng,
                                          local)
    jstate, jmeas, count_j, ok_j = reference(partner, local)

    given_state, _ = convert.state_from_numpy(arrays, "cpu", t_dtype)
    given_state = dataclasses.replace(given_state, **{
        f.name: getattr(given_state, f.name).clone()
        for f in dataclasses.fields(given_state)})
    given_meas = dataclasses.replace(
        amt.state.Measurements.zeros(200, t_dtype, num_particles=n),
        pending_vals=torch.from_numpy(pending_vals).clone(),
        pending_mask=torch.from_numpy(pending_mask).clone())
    tstate = dataclasses.replace(given_state, **{
        f.name: getattr(given_state, f.name).clone()
        for f in dataclasses.fields(given_state)})
    tmeas = dataclasses.replace(
        given_meas, pending_vals=given_meas.pending_vals.clone(),
        pending_mask=given_meas.pending_mask.clone())
    ptrs = [t.data_ptr() for t in (tstate.pos, tstate.vel, tstate.paths,
                                   tstate.has_collided, tmeas.pending_vals,
                                   tmeas.pending_mask)]
    count = torch.full((), 5, dtype=torch.int32)
    out = tcollide.resolve_pairs_plain(
        tstate, tmeas, torch.from_numpy(partner), cr, count=count,
        local_mask=None if local is None else torch.from_numpy(local))

    assert out[0] is tstate and out[1] is tmeas and out[2] is count
    assert ptrs == [t.data_ptr() for t in (
        tstate.pos, tstate.vel, tstate.paths, tstate.has_collided,
        tmeas.pending_vals, tmeas.pending_mask)]
    ok = np.asarray(ok_j)
    applied = ok if local is None else ok & local
    assert int(count) == 5 + int(count_j) > 5 + 20
    if local is not None:
        np.testing.assert_array_equal(out[3].numpy(), ok)
        split = lanes["split"]
        assert ok[split].all() and (applied[split] == local[split]).all()
        assert (~local[split]).sum() == 60
    for case in ("chain", "selfish"):
        assert not ok[lanes[case]].any(), case
    assert ok[partner[lanes["chain"]]].all()
    for f in ("pos", "vel", "paths"):
        assert_floats(getattr(tstate, f).numpy(), getattr(jstate, f),
                      np_dtype)
        np.testing.assert_array_equal(
            getattr(tstate, f).numpy()[~applied],
            getattr(given_state, f).numpy()[~applied])
    np.testing.assert_array_equal(tstate.has_collided.numpy(),
                                  np.asarray(jstate.has_collided))
    np.testing.assert_array_equal(tmeas.pending_mask.numpy(),
                                  np.asarray(jmeas.pending_mask))
    assert_floats(tmeas.pending_vals.numpy(), jmeas.pending_vals, np_dtype)
    for got, was in ((tstate.has_collided, given_state.has_collided),
                     (tmeas.pending_vals, given_meas.pending_vals),
                     (tmeas.pending_mask, given_meas.pending_mask)):
        np.testing.assert_array_equal(got.numpy()[~applied],
                                      was.numpy()[~applied])


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
    count = torch.zeros((), dtype=torch.int32)
    if slab:
        tcollide.bin_and_table(pos_t, tgrid, valid=valid_t)
        tcollide.partner_sweep(pos_t, table, pslot, tgrid, cr, ids=ids_t,
                               valid=valid_t, cell_window=(100, 50))
        out = tcollide.resolve_pairs(state, meas, pslot, cr,
                                     local_mask=valid_t)
        assert len(out) == 4 and out[3].shape == (n,) and out[2] is None
    else:
        tcollide.bin_and_table(pos_t, tgrid)
        tcollide.partner_sweep(pos_t, table, pslot, tgrid, cr)
        out = tcollide.resolve_pairs(state, meas, pslot, cr, count=count)
        assert len(out) == 3 and out[2] is count
        assert out[0] is state and out[1] is meas
    given = (lambda a: a.value is not None) if slab else (
        lambda a: a.value is None)
    assert given(calls["bin_and_table"][1])
    assert all(given(a) for a in calls["partner_sweep"][4:6])
    assert calls["partner_sweep"][11:13] == (
        (100, 50) if slab else (0, tgrid.num_cells))
    assert calls["partner_sweep"][9:11] == (
        tgrid.run_start.shape[0] - 1, tcollide.RUN_CELLS)
    # The state and staging are passed as they are (in place), the local
    # mask and ok with the slab's arguments, the count without them.
    assert [a.value for a in calls["resolve_pairs"][:7]] == [
        t.data_ptr() for t in (state.pos, state.vel, state.paths,
                               state.has_collided, pslot, meas.pending_vals,
                               meas.pending_mask)]
    assert given(calls["resolve_pairs"][7])
    assert given(calls["resolve_pairs"][-2])
    assert (calls["resolve_pairs"][-1].value is not None) != slab


# --------------------------------------------------------------------------
# What K9's cell walk leans on: the table's row contract, the run
# arithmetic, and the shapes the walk finds hard
# --------------------------------------------------------------------------


def crowded_positions(cfg, rng, clump=40):
    """``clustered_positions`` plus ``clump`` particles inside one
    collision range of a base particle, so that one cell is over any small
    capacity."""
    pos = clustered_positions(cfg, rng)
    cr = cfg.physics.collision_range
    d = rng.normal(size=(clump, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    crowd = pos[7] + d * cr * rng.uniform(0.05, 0.45, (clump, 1))
    return np.concatenate([pos, crowd])[rng.permutation(pos.shape[0] + clump)]


@pytest.mark.parametrize("with_valid", [False, True],
                         ids=["all-lanes", "valid"])
@pytest.mark.parametrize("capacity", [None, 8])
def test_table_rows_are_ascending_and_sentinel_terminated(capacity,
                                                          with_valid):
    """The contract of K2's table that the cell walk reads rows by: equal
    to the reference's table; every row lists particle indices ascending,
    from the front, and holds only the sentinel after its first sentinel;
    the dummy row is all sentinel; a particle has a slot exactly when its
    row lists it, at that slot; a full cell keeps its lowest indices."""
    cfg, host_grid = pore_setup(capacity)
    jgrid, tgrid = grids(host_grid, np.float32, torch.float32)
    rng = np.random.default_rng(11)
    pos = crowded_positions(cfg, rng).astype(np.float32)
    n = pos.shape[0]
    valid = rng.uniform(size=n) > 0.1 if with_valid else None
    jvalid = None if valid is None else jnp.asarray(valid)
    tvalid = None if valid is None else torch.from_numpy(valid)

    cid_j = jcollide.assign_cells(jnp.asarray(pos), jgrid, jvalid)
    table_j, overflow_j, _ = jcollide.build_cell_table(cid_j, jgrid)
    cid, table, pslot, overflow = tcollide.bin_and_table_plain(
        torch.from_numpy(pos), tgrid, valid=tvalid)
    table, pslot, cid = table.numpy(), pslot.numpy(), cid.numpy()
    np.testing.assert_array_equal(table, np.asarray(table_j))
    assert int(overflow) == int(overflow_j)
    if capacity == 8:
        assert int(overflow) > 0

    cap, cells = host_grid.capacity, host_grid.num_cells
    listed = table < n
    count = listed.sum(axis=1)
    # From the front, nothing after the first sentinel.
    np.testing.assert_array_equal(listed,
                                  np.arange(cap)[None, :] < count[:, None])
    assert (table[~listed] == n).all() and count[cells] == 0
    # Ascending inside a row.
    both = listed[:, 1:]
    assert (np.diff(table, axis=1)[both] > 0).all()
    # pslot is the inverse of the table, the dummy slot for the rest.
    rows, slots = np.nonzero(listed)
    np.testing.assert_array_equal(pslot[table[rows, slots]],
                                  rows * cap + slots)
    np.testing.assert_array_equal(cid[table[rows, slots]], rows)
    unlisted = np.ones(n, bool)
    unlisted[table[listed]] = False
    assert (pslot[unlisted] == cells * cap).all()
    if valid is not None:
        assert unlisted[~valid].all()
    # A full cell keeps its lowest indices.
    for c in np.flatnonzero(count == cap)[:20]:
        members = np.flatnonzero(cid == c)
        np.testing.assert_array_equal(table[c], members[:cap])


@pytest.mark.parametrize("with_valid", [False, True],
                         ids=["all-lanes", "valid"])
@pytest.mark.parametrize("capacity", [None, 8])
@pytest.mark.parametrize("shape", ["clump-40", "clump-150", "one-cell"])
def test_bin_and_table_plain_long_segments(shape, capacity, with_valid):
    """Segments longer than a warp, where K2's table fill takes its
    long-segment path: a cell holding over 32 and over 100 particles, and
    every particle in one cell, at the auto capacity and at 8, with and
    without ``valid``; equal to the reference's assign_cells +
    build_cell_table, the crowded cell keeping its lowest indices."""
    cfg, host_grid = pore_setup(capacity)
    jgrid, tgrid = grids(host_grid, np.float32, torch.float32)
    rng = np.random.default_rng(13)
    if shape == "one-cell":
        pos = np.repeat(clustered_positions(cfg, rng)[:1], 3000, axis=0)
    else:
        pos = crowded_positions(cfg, rng, clump=int(shape.split("-")[1]))
    pos = pos.astype(np.float32)
    n = pos.shape[0]
    valid = rng.uniform(size=n) > 0.1 if with_valid else None
    jvalid = None if valid is None else jnp.asarray(valid)
    tvalid = None if valid is None else torch.from_numpy(valid)

    cid_j = jcollide.assign_cells(jnp.asarray(pos), jgrid, jvalid)
    table_j, overflow_j, pslot_j = jcollide.build_cell_table(cid_j, jgrid)
    cid, table, pslot, overflow = tcollide.bin_and_table_plain(
        torch.from_numpy(pos), tgrid, valid=tvalid)
    np.testing.assert_array_equal(cid.numpy(), np.asarray(cid_j))
    np.testing.assert_array_equal(table.numpy(), np.asarray(table_j))
    np.testing.assert_array_equal(overflow.numpy(), np.asarray(overflow_j))
    live = np.ones(n, bool) if valid is None else valid
    np.testing.assert_array_equal(pslot.numpy()[live],
                                  np.asarray(pslot_j)[live])
    cells = cid.numpy()[live]
    counts = np.bincount(cells[cells < tgrid.num_cells])
    assert counts.max() > {"clump-40": 32, "clump-150": 100}.get(shape, 2000)
    crowded = np.argmax(counts)
    members = np.flatnonzero((cid.numpy() == crowded) & live)
    np.testing.assert_array_equal(table.numpy()[crowded],
                                  members[:tgrid.capacity])
    assert int(overflow) == np.maximum(counts - tgrid.capacity, 0).sum()


@pytest.mark.parametrize("target", [TARGET, 1_000_000],
                         ids=["pore-4k", "pore-1M"])
def test_cell_runs_and_staged_rows_equal_grid_neighbors(target):
    """The cell walk's arithmetic on the host: the runs cut the cell ids
    into pieces of at most RUN_CELLS cells that stay inside one x-row, and
    for every cell k of every run the staged rows k, k + 1, k + 2 of group
    g are ``Grid.neighbors[cell, 3g : 3g + 3]`` -- layer edges, the change
    of nx between layers and the dummy row included."""
    cfg = amc.temperature_pore_config().scaled_to(target)
    eng = jcfg.EngineConfig()
    n, vol = cfg.num_molecules, cfg.geometry.volume
    host = jcollide.grid_for_pore(
        cfg.geometry, jcfg.cell_size_for(eng, cfg.physics, n, vol),
        jcfg.cell_capacity_for(eng, cfg.physics, n, vol))
    # The port's own host grid is the reference's, array for array.
    ours = tcollide.grid_for_pore(cfg.geometry, host.cell_size,
                                  host.capacity)
    np.testing.assert_array_equal(ours.neighbors, host.neighbors)
    cells = host.num_cells
    starts = tcollide.cell_runs(host.nx, host.layer_base)
    length = np.diff(starts)
    assert starts[0] == 0 and starts[-1] == cells and starts.dtype == np.int32
    assert length.min() >= 1 and length.max() <= tcollide.RUN_CELLS
    assert len(set(host.nx.tolist())) > 1      # nx changes between layers
    # A run stays inside one x-row: same layer, same iy.
    layer = np.searchsorted(host.layer_base, starts[:-1], side="right") - 1
    local = starts[:-1] - host.layer_base[layer]
    nx = host.nx[layer]
    assert (local // nx == (local + length - 1) // nx).all()
    assert (local + length <= nx * nx).all()

    rows = tcollide.run_rows(host.neighbors, starts)
    assert rows.shape == (len(length), 9, tcollide.RUN_CELLS + 2)
    cell = np.arange(cells)
    run = np.searchsorted(starts, cell, side="right") - 1
    k = cell - starts[run]
    grouped = host.neighbors.reshape(cells, 9, 3)
    for dx in range(3):
        staged = rows[run[:, None], np.arange(9)[None, :], (k + dx)[:, None]]
        np.testing.assert_array_equal(staged, grouped[:, :, dx])
    assert (grouped == cells).any()            # edges reach the dummy row
    # Beyond a short run the staged rows are the empty dummy row.
    beyond = np.arange(tcollide.RUN_CELLS + 2)[None, :] >= length[:, None] + 2
    assert (rows.transpose(0, 2, 1)[beyond] == cells).all()
    # The device grid carries the same runs.
    _, tgrid = grids(host, np.float32, torch.float32)
    np.testing.assert_array_equal(tgrid.run_start.numpy(), starts)


@pytest.mark.parametrize("target", [TARGET, 1_000_000],
                         ids=["pore-4k", "pore-1M"])
def test_half_shell_staged_rows_equal_grid_neighbors(target):
    """K1's walk on the host: for every cell k of every run, rows k + 1 and
    k + 2 of group 4 and rows k, k + 1, k + 2 of groups 5 to 8 are
    ``Grid.neighbors[cell, 13:27]``, column for column; the one staged row
    only column 12 would read is the dummy row."""
    cfg = amc.temperature_pore_config().scaled_to(target)
    eng = jcfg.EngineConfig()
    n, vol = cfg.num_molecules, cfg.geometry.volume
    host = jcollide.grid_for_pore(
        cfg.geometry, jcfg.cell_size_for(eng, cfg.physics, n, vol),
        jcfg.pairs_cell_capacity_for(eng, cfg.physics, n, vol))
    cells = host.num_cells
    starts = tcollide.cell_runs(host.nx, host.layer_base)
    rows = tcollide.half_shell_rows(host.neighbors, starts)
    assert rows.shape == (len(starts) - 1, 5, tcollide.RUN_CELLS + 2)
    assert (rows[:, 0, 0] == cells).all()
    cell = np.arange(cells)
    run = np.searchsorted(starts, cell, side="right") - 1
    k = cell - starts[run]
    shell = np.concatenate(
        [rows[run, 0, k + 1][:, None], rows[run, 0, k + 2][:, None]]
        + [rows[run, h, k + dx][:, None]
           for h in range(1, 5) for dx in range(3)], axis=1)
    np.testing.assert_array_equal(shell, host.neighbors[:, 13:27])
    # The own cell is the first row read of the first group.
    np.testing.assert_array_equal(shell[:, 0], cell)
    assert (shell == cells).any()              # edges reach the dummy row


def _hard_case(name, cfg, host_grid, rng):
    """(pos, ids, valid, window, check) for one shape the cell walk finds
    hard; ``check(partner, pslot)`` asserts that the case is really there."""
    cr = cfg.physics.collision_range
    g = cfg.geometry
    cap, cells = host_grid.capacity, host_grid.num_cells
    dummy = cells * cap
    ids = valid = window = None
    if name == "full-cell":
        pos = crowded_positions(cfg, rng)

        def check(partner, pslot):
            lost = pslot == dummy
            assert lost.sum() > 10 and (partner[lost] == -1).all()
            assert not np.isin(partner[partner >= 0],
                               np.flatnonzero(lost)).any()
    elif name == "stray":
        # Close pairs in the grid's corner cells, far outside the gas (no
        # active cell there), and beyond the grid, clamped into its edge.
        pos = clustered_positions(cfg, rng)
        half = float(host_grid.half_extent[0])
        corner = np.array([half - 0.3 * host_grid.cell_size] * 2 + [1e-9])
        out = np.array([3 * half, -3 * half, g.total_height + 5e-9])
        d = np.array([0.4 * cr, 0.0, 0.0])
        pos = np.concatenate([pos, [corner, corner + d, out, out + d]])
        first = pos.shape[0] - 4

        def check(partner, pslot):
            np.testing.assert_array_equal(
                partner[first:], [first + 1, first, first + 3, first + 2])
            active = np.zeros(cells + 1, bool)
            active[host_grid.active_cells] = True
            assert not active[pslot[first:first + 2] // cap].any()
    elif name == "empty-region":
        pos = clustered_positions(cfg, rng)
        pos = pos[pos[:, 2] > 0.6 * g.total_height]

        def check(partner, pslot):
            occupied = np.zeros(cells + 1, bool)
            occupied[pslot // cap] = True
            assert occupied[:cells].mean() < 0.5 and (partner >= 0).sum() > 100
    elif name == "ragged-n":
        pos = clustered_positions(cfg, rng)[:3677]

        def check(partner, pslot):
            assert all(pos.shape[0] % k for k in (2, 3, 7, 8, 32, 256))
            assert (partner >= 0).sum() > 100
    elif name == "ghost-copy":
        pos, ids, valid = slab_lanes(cfg, rng, np.float64, id_order=True)
        copied = np.bincount(ids)[ids] > 1

        def check(partner, pslot):
            has = partner >= 0
            assert (ids[partner[has]] != ids[has]).all()
            # A copy sits at distance zero and is skipped all the same.
            assert has[copied].any() and (partner[~valid] == -1).all()
    elif name == "window-cut":
        # The window starts and ends in the middle of an x-row, so runs and
        # neighbourhoods straddle both ends; partners outside it are kept.
        pos = clustered_positions(cfg, rng)
        iz = host_grid.nz // 2
        nx = int(host_grid.nx[iz])
        iy, ix = nx // 2, nx // 2 - 1
        start = int(host_grid.layer_base[iz]) + iy * nx + ix
        window = (start, 3 * nx * nx + 5)
        # A pair across the window's first cell boundary along x.
        size, half = host_grid.cell_size, float(host_grid.half_extent[iz])
        edge = np.array([ix * size - half, (iy + 0.5) * size - half,
                         host_grid.z_lo + (iz + 0.5) * size])
        d = np.array([0.2 * cr, 0.0, 0.0])
        pos = np.concatenate([pos, [edge + d, edge - d]])

        def check(partner, pslot):
            cell = pslot // cap
            inside = (cell >= window[0]) & (cell < window[0] + window[1])
            assert (partner[~inside] == -1).all()
            has = inside & (partner >= 0)
            assert has.sum() > 20
            assert (~inside[partner[has]]).any()
    return pos, ids, valid, window, check


@pytest.mark.parametrize("case", ["full-cell", "stray", "empty-region",
                                  "ragged-n", "ghost-copy", "window-cut"])
def test_partner_sweep_plain_matches_reference_on_hard_shapes(case):
    capacity = 4 if case == "full-cell" else None
    cfg, host_grid = pore_setup(capacity)
    jgrid, tgrid = grids(host_grid, np.float32, torch.float32)
    pos, ids, valid, window, check = _hard_case(
        case, cfg, host_grid, np.random.default_rng(21))
    pos = pos.astype(np.float32)
    radius = cfg.physics.collision_range

    def maybe(a, to):
        return None if a is None else to(a)

    partner_j, overflow_j = jcollide.cell_partner_search(
        jnp.asarray(pos), jgrid, radius, ids=maybe(ids, jnp.asarray),
        valid=maybe(valid, jnp.asarray), cell_window=window)
    pos_t = torch.from_numpy(pos)
    _, table, pslot, overflow_t = tcollide.bin_and_table_plain(
        pos_t, tgrid, valid=maybe(valid, torch.from_numpy))
    partner_t = tcollide.partner_sweep_plain(
        pos_t, table, pslot, tgrid, radius, chunk=1024,
        ids=maybe(ids, torch.from_numpy),
        valid=maybe(valid, torch.from_numpy), cell_window=window)
    np.testing.assert_array_equal(partner_t.numpy(), np.asarray(partner_j))
    assert int(overflow_t) == int(overflow_j)
    check(partner_t.numpy(), pslot.numpy())
