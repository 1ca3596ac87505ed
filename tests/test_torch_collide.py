"""Port vs reference: the plain versions of K2 (cell binning and table), K9
(partner sweep) and K10 (impulse exchange) against the JAX functions on
the same numpy-seeded inputs.

Tolerances: integer outputs (cell ids, table, pslot, overflow, partners,
masks, counts) are exact.  Floats: float64 within 1e-12 relative, float32
within 4 ulp of the array's magnitude (both packages round every
operation the same way; the bound leaves room for the XLA CPU compiler's
own choices).
"""

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
