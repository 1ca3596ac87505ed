"""Port vs reference, function by function: the pairs engine's plain twins
of K1 (rebuild sweep), K5 (pair emission), K3 (test and resolve), K4
(dirty re-search) and K6 (compaction) against ``argon_monte_carlo_tpu``'s
ops on the same numpy-seeded inputs, plus the kernel argument tables.

Tolerances: every integer and boolean output (candidates, unswept, pair
entries, cursors, masks, counts, staging mask) is exact, as are the
rebuild-time planes gathered from the same positions.  Floats in float64
within 1e-12 relative.  The rebuild's candidate sets may differ only by a
candidate whose d^2 lies within 1 ulp of its threshold (XLA may sum in
another order); the K1 test checks that any difference is of that kind.
"""

import ctypes
import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import argon_monte_carlo_tpu as amc
from argon_monte_carlo_tpu import config as jcfg
from argon_monte_carlo_tpu.ops import collide as jcollide
from argon_monte_carlo_tpu.ops import pairs as jpairs
from argon_monte_carlo_tpu.ops.compact import compact_indices as jcompact
from argon_monte_carlo_tpu.state import Measurements as JMeasurements
from argon_monte_carlo_tpu.state import ParticleState as JState
from argon_monte_carlo_tpu_torch import convert, kernels
from argon_monte_carlo_tpu_torch.ops import collide as tcollide
from argon_monte_carlo_tpu_torch.ops import compact as tcompact
from argon_monte_carlo_tpu_torch.ops import measure as tmeasure
from argon_monte_carlo_tpu_torch.ops import pairs as tpairs
from argon_monte_carlo_tpu_torch.state import Measurements as TMeasurements
from test_torch_collide import clustered_positions

TARGET = 4000
K = 8


def setup(capacity=None, seed=1, cut_active=False):
    """Pore config at TARGET, the pairs grid on both sides (active list
    included; with ``cut_active`` every third of its cells taken off it),
    and a float64 state: clustered positions with strays, Maxwell-like
    velocities, a few very fast particles.  The velocities are whole m/s,
    so their squares and sums are exact and XLA's fused sum of squares
    gives the port's speeds bitwise."""
    cfg = amc.temperature_pore_config().scaled_to(TARGET)
    n, vol = cfg.num_molecules, cfg.geometry.volume
    eng = jcfg.EngineConfig(cell_capacity=capacity)
    size = jcfg.cell_size_for(eng, cfg.physics, n, vol)
    cap = jcfg.pairs_cell_capacity_for(eng, cfg.physics, n, vol)
    host = jcollide.grid_for_pore(cfg.geometry, size, cap)
    if cut_active:
        keep = np.arange(host.active_cells.shape[0]) % 3 != 0
        host = dataclasses.replace(host,
                                   active_cells=host.active_cells[keep])
    jgrid = jcollide.DeviceGrid.from_grid(host, np.float64,
                                          packed_layers=True)
    tgrid = convert.grid_from_numpy(
        {f: getattr(host, f) for f in
         ("nx", "layer_base", "half_extent", "neighbors", "cell_size",
          "z_lo", "nz", "num_cells", "capacity", "active_cells")},
        device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(seed)
    pos = clustered_positions(cfg, rng)
    n = pos.shape[0]
    vel = np.round(rng.normal(size=(n, 3)) * 250.0)
    vel[rng.choice(n, 5, replace=False)] *= 400.0  # reach clips
    arrays = {"pos": pos, "vel": vel,
              "paths": rng.uniform(0, 2e-7, (n, 4)),
              "has_collided": rng.uniform(size=n) < 0.7}
    return cfg, jgrid, tgrid, arrays, rng


def jax_state(arrays):
    return JState(**{k: jnp.asarray(v) for k, v in arrays.items()})


def pair_config(**changes):
    pcfg = tpairs.default_pair_config(TARGET, K, pair_expectation=0.6)
    return dataclasses.replace(pcfg, **changes)


def to_jax_pcfg(pcfg):
    return jpairs.PairConfig(**dataclasses.asdict(pcfg),
                             occupancy_skip=False)


def jax_rebuild(cfg, jgrid, arrays, pcfg):
    n = arrays["pos"].shape[0]
    old = jpairs.PairList.init(n, jgrid, to_jax_pcfg(pcfg), jnp.float64)
    return jpairs.rebuild(jax_state(arrays), jgrid, to_jax_pcfg(pcfg),
                          cfg.physics.collision_range, cfg.dt, old)


def port_pairlist(jplist, cap):
    return convert.pairlist_from_numpy(
        {f.name: np.asarray(getattr(jplist, f.name))
         for f in dataclasses.fields(jplist)}, cap, "cpu", torch.float64)


def assert_pairlists_equal(got, want, n):
    """Every PairList field equal; the planes compared on real slots."""
    for f in ("a", "b", "cursor", "age", "pslot0", "hot", "pending1",
              "overflow", "spill", "idx0"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(want, f).numpy(), err_msg=f)
    real = want.idx0.numpy() < n
    for f in ("pos0", "reach0"):
        np.testing.assert_array_equal(getattr(got, f).numpy()[real],
                                      getattr(want, f).numpy()[real],
                                      err_msg=f)


def assert_within_ulps(got, want, ulps):
    got, want = np.asarray(got), np.asarray(want)
    assert (np.abs(got - want) <= ulps * np.spacing(np.abs(want))).all()


def test_speed_matches_linalg_norm_float64():
    """The one speed formula sqrt((vx*vx + vy*vy) + vz*vz) against
    jnp.linalg.norm: within 1 ulp, because XLA's CPU backend contracts the
    sum of squares into fused multiply-adds (about 1 value in 10 lands one
    ulp away); the formula itself is the reference's order."""
    vel = np.random.default_rng(0).normal(size=(20000, 3)) * 400.0
    vel[::7] *= 1e-3
    got = tmeasure.speed(torch.from_numpy(vel)).numpy()
    assert_within_ulps(got, jnp.linalg.norm(jnp.asarray(vel), axis=-1), 1)
    x, y, z = vel.T
    np.testing.assert_array_equal(got, np.sqrt((x * x + y * y) + z * z))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_reach_radii_matches_reference(dtype):
    """Within 2 ulp (the speed's 1-ulp latitude, carried through one
    multiply-add); the clip flags exact."""
    cfg, jgrid, _, arrays, _ = setup()
    vel = arrays["vel"].astype(dtype)
    args = (cfg.physics.collision_range, cfg.dt, K, 0.5 * jgrid.cell_size)
    reach_j, clip_j = jpairs.reach_radii(jnp.asarray(vel), *args)
    reach_t, clip_t = tpairs.reach_radii(torch.from_numpy(vel), *args)
    assert reach_t.numpy().dtype == np.dtype(dtype)
    assert_within_ulps(reach_t.numpy(), reach_j, 2)
    np.testing.assert_array_equal(clip_t.numpy(), np.asarray(clip_j))
    assert 0 < int(clip_t.sum()) < vel.shape[0]


# capacity, top_k, every reach at its largest (half a cell), active list cut
SWEEP_CASES = {
    None: (None, 3, False, False),
    4: (4, 3, False, False),
    "saturated": (None, 2, True, False),
    "inactive-cells": (None, 3, False, True),
    "overflowing-saturated": (3, 4, True, False),
}


@pytest.mark.parametrize("capacity", list(SWEEP_CASES))
def test_rebuild_sweep_plain_matches_reference(capacity):
    """K1: cands and unswept against cell_candidate_search in reach mode,
    one-sided, half shell, on the active rows; a widened reach fills rows
    at top_k=3, strays land in inactive cells, capacity 4 spills.  The
    corners the cell-ordered kernel leans on: most emitters with more hits
    than top_k keeps (the kept ones are the lowest indices whatever the
    order they were found in), a third of the active cells taken off the
    list (their particles unswept, yet candidates of their neighbours),
    and full cells with saturated rows together."""
    capacity, top_k, saturate, cut = SWEEP_CASES[capacity]
    cfg, jgrid, tgrid, arrays, _ = setup(capacity, cut_active=cut)
    n = arrays["pos"].shape[0]
    cr = cfg.physics.collision_range
    reach_j, _ = jpairs.reach_radii(jnp.asarray(arrays["vel"]), 8.0 * cr,
                                    cfg.dt, K, 0.5 * jgrid.cell_size)
    if saturate:
        reach_j = jnp.full_like(reach_j, 0.5 * jgrid.cell_size)
    reach = np.array(reach_j)
    cands_j, overflow_j, (pslot_j, mega_j, unswept_j) = \
        jcollide.cell_candidate_search(
            jnp.asarray(arrays["pos"]), jgrid, reach=reach_j, top_k=top_k,
            one_sided=True, half_shell=True, occupancy_skip=False)

    pos = torch.from_numpy(arrays["pos"])
    _, table, pslot, overflow = tcollide.bin_and_table_plain(pos, tgrid)
    cands, unswept, pos0, reach0 = tcollide.rebuild_sweep_plain(
        pos, torch.from_numpy(reach), table, pslot, tgrid, top_k,
        chunk=1000)

    assert int(overflow) == int(overflow_j)
    np.testing.assert_array_equal(pslot.numpy(), np.asarray(pslot_j))
    np.testing.assert_array_equal(unswept.numpy(), np.asarray(unswept_j))
    got, want = cands.numpy(), np.asarray(cands_j)
    for i in np.nonzero((got != want).any(axis=1))[0]:
        # Only a flip within 1 ulp of the threshold may differ.
        for j in set(got[i]) ^ set(want[i]):
            if j < 0:
                continue
            d2 = float(np.sum((arrays["pos"][i] - arrays["pos"][j]) ** 2))
            th2 = float((reach[i] + reach[j]) ** 2)
            assert abs(d2 - th2) <= np.spacing(th2), (i, j)
    planes = np.asarray(mega_j).reshape(-1, 5, tgrid.capacity)
    real = table.numpy() < n
    np.testing.assert_array_equal(
        pos0.numpy()[real], np.moveaxis(planes[:, :3], 1, 2)[real])
    np.testing.assert_array_equal(reach0.numpy()[real], planes[:, 4][real])
    assert unswept.any(), "no stray landed in an inactive cell"
    assert (got[:, -1] >= 0).sum() > 10, "no row filled"
    # Rows are ascending, -1 padded at the end only.
    filled = np.where(got >= 0, got, np.iinfo(np.int32).max)
    assert (np.diff(filled.astype(np.int64), axis=1) >= 0).all()
    if capacity is not None:
        assert int(overflow) > 0
    if saturate:
        # Many emitters have more hits than top_k keeps, and the kept ones
        # are the lowest of all their hits.
        wide = tcollide.rebuild_sweep_plain(
            pos, torch.from_numpy(reach), table, pslot, tgrid, top_k + 3,
            chunk=1000)[0].numpy()
        assert (wide[:, top_k] >= 0).sum() > 50
        np.testing.assert_array_equal(got, wide[:, :top_k])
    if cut:
        # Unswept particles emit nothing but are still found by others.
        assert unswept.sum() > n // 5
        assert (got[unswept.numpy()] == -1).all()
        assert np.isin(got[got >= 0], np.flatnonzero(unswept.numpy())).any()


@pytest.mark.parametrize("capacity,pair_capacity", [(None, None), (4, 150)])
def test_rebuild_matches_reference(capacity, pair_capacity):
    """K2 + K1 + K5: the whole rebuild, every PairList field exact; with
    capacity 4 particles spill hot, and a small pair_capacity drops
    entries (the reference's overflow formula)."""
    cfg, jgrid, tgrid, arrays, _ = setup(capacity)
    n = arrays["pos"].shape[0]
    pcfg = pair_config()
    if pair_capacity is not None:
        pcfg = dataclasses.replace(pcfg, pair_capacity=pair_capacity)
    want = port_pairlist(jax_rebuild(cfg, jgrid, arrays, pcfg),
                         tgrid.capacity)
    state, _ = convert.state_from_numpy(arrays, "cpu", torch.float64)
    old = tpairs.PairList.init(n, tgrid, pcfg, torch.float64, "cpu")
    got = tpairs.rebuild(state, tgrid, pcfg, cfg.physics.collision_range,
                         cfg.dt, old)
    assert_pairlists_equal(got, want, n)
    assert int(got.cursor) > 0 and got.hot.any() and got.pending1.any()
    if capacity == 4:
        assert int(got.spill) > 0
    if pair_capacity is not None:
        assert int(got.overflow) > 0


def emit_case(n, top_k, density, rng):
    """Candidate rows as K1 leaves them -- the lowest indices ascending,
    then -1 -- with a few rows holding gaps, and the rebuild's other
    inputs, from ``rng``."""
    cands = np.sort(rng.integers(0, n, (n, top_k)), axis=1).astype(np.int32)
    keep = rng.uniform(size=(n, 1)) < density
    width = rng.integers(1, top_k + 1, (n, 1))
    cands = np.where(keep & (np.arange(top_k) < width), cands, -1)
    gaps = rng.uniform(size=(n, top_k)) < 0.02
    cands = np.where(gaps, -1, cands).astype(np.int32)
    dummy = 5 * n
    pslot0 = rng.integers(0, dummy + 2, n).astype(np.int32)
    clipped = rng.uniform(size=n) < 0.01
    unswept = rng.uniform(size=n) < 0.02
    return cands, pslot0, clipped, unswept, dummy


@pytest.mark.parametrize("m_cap", ["above", "equal", "below", "none"])
def test_emit_pairs_plain_matches_reference(m_cap):
    """K5's twin against the JAX ``rebuild_finish`` at a pair capacity
    above, equal to and below the entry count, and with no candidate at
    all, at N = 5125 (not a multiple of the kernel's 4,096-particle tile):
    the list, its padding with n, the cursor, hot, pending1 and both
    counters exact."""
    rng = np.random.default_rng(21)
    n, top_k = 5125, 4
    cands, pslot0, clipped, unswept, dummy = emit_case(
        n, top_k, 0.0 if m_cap == "none" else 0.4, rng)
    entries = int((cands >= 0).sum())
    cap = {"above": entries + 321, "equal": entries, "below": entries // 3,
           "none": 64}[m_cap]
    assert n % tpairs.EMIT_TILE != 0 and (entries > 0) == (m_cap != "none")
    cell_overflow, old_overflow, old_spill = 3, 11, 7

    grid = dataclasses.make_dataclass("G", ["num_cells", "capacity"])(
        dummy // 5, 5)
    pcfg = dataclasses.make_dataclass("P", ["pair_capacity", "top_k"])(
        cap, top_k)
    old = dataclasses.make_dataclass("O", ["overflow", "spill"])(
        jnp.int32(old_overflow), jnp.int32(old_spill))
    want = jpairs.rebuild_finish(
        jnp.asarray(cands), jnp.int32(cell_overflow), jnp.asarray(pslot0),
        None, jnp.asarray(unswept), jnp.asarray(clipped), old, grid, pcfg, n)

    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    got = tpairs.emit_pairs_plain(
        torch.from_numpy(cands), torch.from_numpy(pslot0),
        torch.from_numpy(clipped), torch.from_numpy(unswept),
        i32(cell_overflow), i32(old_overflow), i32(old_spill), dummy, cap)
    for name, g in zip(("a", "b", "cursor", "hot", "pending1", "overflow",
                        "spill"), got):
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    a, b, cursor = got[0].numpy(), got[1].numpy(), int(got[2])
    assert cursor == min(entries, cap)
    assert (a[cursor:] == n).all() and (b[cursor:] == n).all()
    assert (int(got[5]) > old_overflow) == (m_cap == "below")
    assert got[4].any() == (m_cap != "none") and got[3].any()


def k3_case(event_capacity, repeated=False):
    """K3's inputs on a rebuilt list with 300 reversed duplicates appended
    (and, with ``repeated``, 300 repeated ones after them), run through the
    JAX reference.  Returns (reference outputs, the port's inputs: state,
    measurements, a, b, cr)."""
    cfg, jgrid, tgrid, arrays, rng = setup()
    n = arrays["pos"].shape[0]
    cr = cfg.physics.collision_range
    jplist = jax_rebuild(cfg, jgrid, arrays, pair_config())
    a, b = np.array(jplist.a), np.array(jplist.b)
    live = int(jplist.cursor)
    a[live:live + 300], b[live:live + 300] = b[:300], a[:300]
    if repeated:
        a[live + 300:live + 600], b[live + 300:live + 600] = a[:300], b[:300]
    jplist.a, jplist.b = jnp.asarray(a), jnp.asarray(b)
    pending_mask = rng.uniform(size=n) < 0.1
    # Within the staging's contract: a row whose mask is clear is zero.
    pending_vals = np.where(pending_mask[:, None],
                            rng.uniform(0, 1e-6, (n, 4)), 0.0)

    jmeas = JMeasurements.zeros(200, np.float64, num_particles=n)
    jmeas.pending_vals = jnp.asarray(pending_vals)
    jmeas.pending_mask = jnp.asarray(pending_mask)
    want = jpairs.test_and_resolve(jax_state(arrays), jmeas, jplist, cr, 200,
                                   1e-6, event_capacity)

    tstate, _ = convert.state_from_numpy(arrays, "cpu", torch.float64)
    tstate = dataclasses.replace(tstate, **{
        f.name: getattr(tstate, f.name).clone()
        for f in dataclasses.fields(tstate)})
    tmeas = dataclasses.replace(
        TMeasurements.zeros(200, torch.float64, num_particles=n),
        pending_vals=torch.from_numpy(pending_vals).clone(),
        pending_mask=torch.from_numpy(pending_mask).clone())
    return want, (tstate, tmeas, torch.from_numpy(a), torch.from_numpy(b),
                  cr)


def assert_k3_matches(got, want):
    """K3's outputs against the reference's: collided mask, count, staging
    and counters exact, state within 1e-12."""
    tstate, tmeas, ncol_t, mask_t = got
    jstate, jmeas, ncol_j, mask_j = want
    assert int(ncol_t) == int(ncol_j) > 0
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    for f in ("collision_count", "overflow_count"):
        assert int(getattr(tmeas, f)) == int(getattr(jmeas, f)), f
    np.testing.assert_array_equal(tmeas.pending_mask.numpy(),
                                  np.asarray(jmeas.pending_mask))
    np.testing.assert_allclose(tmeas.pending_vals.numpy(),
                               np.asarray(jmeas.pending_vals), rtol=1e-12,
                               atol=1e-18)
    for f in ("pos", "vel", "paths"):
        ref = np.asarray(getattr(jstate, f))
        np.testing.assert_allclose(getattr(tstate, f).numpy(), ref,
                                   rtol=1e-12,
                                   atol=1e-12 * np.abs(ref).max())
    np.testing.assert_array_equal(tstate.has_collided.numpy(),
                                  np.asarray(jstate.has_collided))


@pytest.mark.parametrize("event_capacity", [8192, 16])
def test_test_and_resolve_plain_matches_reference(event_capacity):
    """K3 on a rebuilt list with reversed duplicates appended, the in-place
    twin fed clones: collided mask, count, staging and counters exact,
    state within 1e-12."""
    want, (tstate, tmeas, a, b, cr) = k3_case(event_capacity)
    got = tpairs.test_and_resolve_plain(
        dataclasses.replace(tstate, **{
            f.name: getattr(tstate, f.name).clone()
            for f in dataclasses.fields(tstate)}),
        dataclasses.replace(tmeas, **{
            f.name: getattr(tmeas, f.name).clone()
            for f in dataclasses.fields(tmeas)}),
        a, b, cr, event_capacity)
    assert_k3_matches(got, want)
    if event_capacity == 16:
        assert int(got[1].overflow_count) > 0


@pytest.mark.parametrize("event_capacity", [8192, 16])
def test_test_and_resolve_plain_updates_in_place(event_capacity):
    """K3's twin writes the state, the staging and the two counters into
    the tensors it is given and returns those tensors, with both reversed
    and repeated duplicate entries colliding (the case where the kernel
    lets exactly one event write a pair); the result is the reference's."""
    want, (tstate, tmeas, a, b, cr) = k3_case(event_capacity, repeated=True)
    n = tstate.pos.shape[0]
    pos = tstate.pos
    listed = (a < n) & (b < n)
    d = pos[b[listed].long()] - pos[a[listed].long()]
    hits = torch.stack([a[listed], b[listed]], 1)[
        (d * d).sum(1) < cr * cr]
    pairs = [tuple(sorted(h.tolist())) for h in hits]
    assert len(pairs) - len(set(pairs)) >= 2   # reversed and repeated
    given_state = {f.name: getattr(tstate, f.name)
                   for f in dataclasses.fields(tstate)}
    given_meas = {f.name: getattr(tmeas, f.name)
                  for f in dataclasses.fields(tmeas)}
    got = tpairs.test_and_resolve_plain(tstate, tmeas, a, b, cr,
                                        event_capacity)
    for name, t in given_state.items():
        assert getattr(got[0], name) is t, name
    for name, t in given_meas.items():
        assert getattr(got[1], name) is t, name
    assert_k3_matches(got, want)
    assert int(tmeas.collision_count) == int(got[2]) > 0


@pytest.mark.parametrize("append_capacity", [None, 40])
def test_research_dirty_plain_matches_reference(append_capacity):
    """K4 after the particles moved: bumps (one clipping), a table-dropped
    particle, a fresh-velocity clip and a teleport onto a neighbour, all
    in one dirty set padded with n; a small append_capacity loses
    coverage."""
    cfg, jgrid, tgrid, arrays, rng = setup(capacity=8)
    n = arrays["pos"].shape[0]
    cr, dt = cfg.physics.collision_range, cfg.dt
    pcfg = pair_config()
    if append_capacity is not None:
        pcfg = dataclasses.replace(pcfg, append_capacity=append_capacity)
    jplist = jax_rebuild(cfg, jgrid, arrays, pcfg)
    pslot0 = np.asarray(jplist.pslot0)
    dropped = np.nonzero(pslot0 >= jgrid.num_cells * jgrid.capacity)[0]
    assert dropped.size > 0

    moved = dict(arrays)
    moved["pos"] = arrays["pos"] + 3 * dt * arrays["vel"]
    moved["vel"] = arrays["vel"].copy()
    dirty = rng.choice(np.arange(1, n), 400, replace=False)
    dirty = np.union1d(dirty, dropped[:3])
    bump = np.zeros(n, bool)
    bump[dirty[::2]] = True
    moved["vel"][dirty[::2]] += 120.0
    moved["vel"][dirty[5]] = [4e4, 0.0, 0.0]          # clips at once
    moved["pos"][dirty[7]] = arrays["pos"][dirty[8]] + [0.5 * cr, 0, 0]
    dirty_idx = np.full(pcfg.research_capacity, n, np.int32)
    dirty_idx[:dirty.size] = np.sort(dirty)

    # Converted first: the reference updates the list it is given.
    tplist = port_pairlist(jplist, tgrid.capacity)
    jnew, lost_j, latent_j = jpairs.research_dirty(
        jax_state(moved), jplist, jnp.asarray(dirty_idx), jnp.asarray(bump),
        jgrid, to_jax_pcfg(pcfg), cr, dt)

    tstate, _ = convert.state_from_numpy(moved, "cpu", torch.float64)
    reach0_before = tplist.reach0.clone()   # the twin updates it in place
    tnew, lost_t, latent_t = tpairs.research_dirty_plain(
        tstate, tplist, torch.from_numpy(dirty_idx), torch.from_numpy(bump),
        tgrid, pcfg, cr, dt)

    assert_pairlists_equal(tnew, port_pairlist(jnew, tgrid.capacity), n)
    assert bool(lost_t) == bool(lost_j)
    np.testing.assert_array_equal(latent_t.numpy(), np.asarray(latent_j))
    assert int(latent_t.sum()) > 0
    assert int(tnew.cursor) > int(tplist.cursor)
    assert not torch.equal(tnew.reach0, reach0_before)
    assert bool(lost_t) == (append_capacity is not None)


@pytest.mark.parametrize("append_capacity", [None, 40])
def test_research_dirty_plain_in_place_equals_copying(append_capacity):
    """K4 in place equals the reference's copying form: every PairList
    field, ``lost`` and ``latent_per`` as the JAX op gives them, with the
    list's ``reach0``, ``hot``, ``a`` and ``b`` updated where they are and
    returned.  And what the kernel's append leans on: a lane's found
    entries are a prefix of its ascending row, so the row-major compaction
    of the found mask is an exclusive scan over the lanes' counts -- lane
    after lane in ``dirty_idx`` order, ascending within a lane, cut only by
    the append budget."""
    cfg, jgrid, tgrid, arrays, rng = setup(capacity=8)
    n = arrays["pos"].shape[0]
    cr, dt = cfg.physics.collision_range, cfg.dt
    pcfg = pair_config()
    if append_capacity is not None:
        pcfg = dataclasses.replace(pcfg, append_capacity=append_capacity)
    jplist = jax_rebuild(cfg, jgrid, arrays, pcfg)
    plist = port_pairlist(jplist, tgrid.capacity)
    moved = dict(arrays)
    moved["pos"] = arrays["pos"] + 3 * dt * arrays["vel"]
    dirty = np.sort(rng.choice(n, 400, replace=False))
    moved["vel"] = arrays["vel"].copy()
    moved["vel"][dirty[::2]] += 120.0
    bump = np.zeros(n, bool)
    bump[dirty[::2]] = True
    dirty_idx = np.full(pcfg.research_capacity, n, np.int32)
    dirty_idx[:2 * dirty.size:2] = dirty    # fill-value lanes in between
    jnew, lost_w, latent_w = jpairs.research_dirty(
        jax_state(moved), jplist, jnp.asarray(dirty_idx), jnp.asarray(bump),
        jgrid, to_jax_pcfg(pcfg), cr, dt)
    want = port_pairlist(jnew, tgrid.capacity)

    mstate, _ = convert.state_from_numpy(moved, "cpu", torch.float64)
    before = {f.name: getattr(plist, f.name).clone()
              for f in dataclasses.fields(plist)}
    got, lost_g, latent_g = tpairs.research_dirty(
        mstate, plist, torch.from_numpy(dirty_idx), torch.from_numpy(bump),
        tgrid, pcfg, cr, dt)
    assert_pairlists_equal(got, want, n)
    assert bool(lost_g) == bool(lost_w) == (append_capacity is not None)
    np.testing.assert_array_equal(latent_g.numpy(), np.asarray(latent_w))
    for name in ("reach0", "hot", "a", "b"):
        assert getattr(got, name) is getattr(plist, name), name
    assert not torch.equal(got.reach0, before["reach0"])

    lo, hi = int(before["cursor"]), int(got.cursor)
    new_a, new_b = got.a[lo:hi].numpy(), got.b[lo:hi].numpy()
    assert hi > lo
    lanes = dirty_idx[dirty_idx < n]
    counts = np.array([(new_a == d).sum() for d in lanes])
    offsets = np.concatenate([[0], np.cumsum(counts)])
    assert offsets[-1] == hi - lo
    assert counts.max() <= pcfg.research_top_k
    for d, off, c in zip(lanes, offsets, counts):
        assert (new_a[off:off + c] == d).all()
        assert (np.diff(new_b[off:off + c]) > 0).all()
        assert (new_b[off:off + c] != d).all()
    if append_capacity is not None:
        assert hi - lo == append_capacity


@pytest.mark.parametrize("case", range(6))
def test_compact_indices_plain_matches_nonzero_contract(case):
    rng = np.random.default_rng(7)
    mask, size = [
        (np.zeros(97, bool), 16),
        (np.ones(97, bool), 16),
        (rng.random(1000) < 0.03, 64),
        (rng.random(1000) < 0.5, 64),
        (rng.random(50) < 0.3, 128),
        (np.array([True]), 4),
    ][case]
    want = jnp.nonzero(jnp.asarray(mask), size=size,
                       fill_value=mask.shape[0])[0]
    got = tcompact.compact_indices_plain(torch.from_numpy(mask), size,
                                         mask.shape[0])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jcompact(jnp.asarray(mask), size, mask.shape[0])))


def test_kernel_signatures_match_sources():
    """The ctypes argument table equals the C declarations, stream last."""
    types = {"P": ctypes.c_void_p, "I": ctypes.c_int, "F": ctypes.c_float}
    declared = {}
    for src in sorted(kernels.CSRC.glob("*.cu")):
        for name, params in re.findall(
                r"AMC_EXPORT int amc_(\w+)\((.*?)\)\s*\{", src.read_text(),
                re.S):
            kinds = ["P" if "*" in p or "cudaStream_t" in p
                     else "F" if p.split()[0] == "float" else "I"
                     for p in params.split(",")]
            declared[name] = [types[k] for k in kinds]
    assert declared == kernels._SIGNATURES


def test_wrappers_pass_declared_arguments(monkeypatch):
    """Each new wrapper, forced down its kernel side with the launch
    intercepted, passes exactly the declared argument kinds."""
    calls, given = [], {}

    def fake_launch(name, device, *args):
        calls.append(name)
        given[name] = args
        sig = kernels._SIGNATURES[name][:-1]  # the stream is launch's
        assert len(args) == len(sig), name
        for arg, kind in zip(args, sig):
            want = {ctypes.c_void_p: ctypes.c_void_p, ctypes.c_int: int,
                    ctypes.c_float: float}[kind]
            assert isinstance(arg, want), (name, arg, kind)

    cfg, _, tgrid, arrays, _ = setup()
    state, _ = convert.state_from_numpy(arrays, "cpu", torch.float32)
    grid = dataclasses.replace(tgrid,
                               half_extent=tgrid.half_extent.float())
    n = state.num_particles
    pcfg = pair_config()
    plist = tpairs.PairList.init(n, grid, pcfg, torch.float32, "cpu")
    meas = TMeasurements.zeros(200, torch.float32, num_particles=n)
    monkeypatch.setattr(kernels, "use_plain", lambda t: False)
    monkeypatch.setattr(kernels, "launch", fake_launch)
    cr, dt = cfg.physics.collision_range, cfg.dt
    reach = torch.zeros(n)
    mask = torch.zeros(n, dtype=torch.bool)
    i32 = torch.zeros((), dtype=torch.int32)
    tcompact.compact_indices(mask, 64, n)
    tcollide.rebuild_sweep(state.pos, reach, plist.idx0, plist.pslot0, grid,
                           pcfg.top_k)
    tpairs.emit_pairs(torch.zeros((n, pcfg.top_k), dtype=torch.int32),
                      plist.pslot0, mask, mask, i32, i32, i32,
                      grid.num_cells * grid.capacity, pcfg.pair_capacity)
    tpairs.test_and_resolve(state, meas, plist.a, plist.b, cr,
                            pcfg.event_capacity)
    tpairs.research_dirty(state, plist, torch.full((64,), n,
                                                   dtype=torch.int32),
                          mask, grid, pcfg, cr, dt)
    tmeasure.flush_hist_compacted(meas, torch.full((64,), n,
                                                   dtype=torch.int32),
                                  200, 1e-6)
    assert calls == ["compact", "rebuild_sweep", "emit_pairs",
                     "test_and_resolve", "research_dirty",
                     "flush_hist_compacted"]
    # K5: the look-back words of its tiles and the unswept count's word,
    # whose length it is told; a and b one allocation, a row each.
    emit = given["emit_pairs"]
    assert emit[-1] >= -(-n // tpairs.EMIT_TILE) + 2
    assert emit[12].value - emit[11].value == 4 * pcfg.pair_capacity
