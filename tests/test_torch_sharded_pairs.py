"""The sharded Verlet pair-list engine: the slab forms of the pairs kernels'
twins (K1, K5, K3, K4 with global ids, valid lanes, cell windows and local
masks) against the JAX ops on the same inputs, the port's 4-slab pairs run
against the JAX ``ShardedSimulation`` in pairs mode step by step, and the
ports of the reference's own sharded-pairs tests (tests/test_sharding.py).

Tolerances: every integer and boolean output (candidates, unswept, pair
entries, cursors, masks, counts, the staging mask, valid, gid, counters,
the histogram) is exact; floats in float64 within 1e-12 relative, the
state of a run within the sweep test's bound (test_torch_sharding.py:
1e-12 relative to the largest value), ``path_sum`` and the ledger within
1e-9.  K1's candidate sets may differ only by a candidate whose d^2 lies
within 1 ulp of its threshold, as in test_torch_pairs.py; a run's
dirty_count by at most the lanes of particles whose speed a step moved by
no more than one ulp, as in test_torch_engine.py.
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
from argon_monte_carlo_tpu.ops import collide as jcollide
from argon_monte_carlo_tpu.ops import pairs as jpairs
from argon_monte_carlo_tpu.parallel import shard as jshard
from argon_monte_carlo_tpu.parallel.mesh import make_mesh
from argon_monte_carlo_tpu.state import Measurements as JMeasurements
from argon_monte_carlo_tpu.state import ParticleState as JState
from argon_monte_carlo_tpu_torch import convert
from argon_monte_carlo_tpu_torch.ops import collide as tcollide
from argon_monte_carlo_tpu_torch.ops import measure as tmeasure
from argon_monte_carlo_tpu_torch.ops import pairs as tpairs
from argon_monte_carlo_tpu_torch.parallel import shard as tshard
from argon_monte_carlo_tpu_torch.state import Measurements as TMeasurements
from test_torch_pairs import (assert_pairlists_equal, pair_config, setup,
                              to_jax_pcfg)
from test_torch_sharding import (COUNTERS, EXACT_METRICS, LEDGER, SLABS,
                                 assert_slabs_match, live, owner_by_gid,
                                 plant_cross_face_pairs, port_sharded,
                                 to_port)

K = 8


# --------------------------------------------------------------------------
# (a) The slab forms of the kernels' twins against the JAX ops
# --------------------------------------------------------------------------


def slab_lanes(seed=3, invalid=0.12):
    """A slab's lanes as the engine holds them: setup()'s particles with a
    share of the lanes empty (far away, at rest) and a permutation of
    global ids, so that id order is not lane order.  Returns (cfg, jgrid,
    tgrid, arrays, ids, valid, rng)."""
    cfg, jgrid, tgrid, arrays, rng = setup(seed=seed)
    n = arrays["pos"].shape[0]
    valid = rng.uniform(size=n) >= invalid
    arrays = dict(arrays)
    arrays["pos"] = np.where(valid[:, None], arrays["pos"], tshard.SENTINEL)
    arrays["vel"] = np.where(valid[:, None], arrays["vel"], 0.0)
    ids = rng.permutation(5 * n)[:n].astype(np.int32)
    return cfg, jgrid, tgrid, arrays, ids, valid, rng


def windows(jgrid, host_active, extra=7):
    """A slab's cell window (the middle third of the layers) and its slice
    of the active list, ``extra`` active cells wider than the window (the
    plan's width is the widest slab's)."""
    base = np.asarray(jgrid.layer_base)
    nz = base.shape[0]
    lo, hi = int(base[nz // 3]), int(base[2 * nz // 3])
    a_lo, a_hi = np.searchsorted(host_active, [lo, hi])
    return (lo, hi - lo), (int(a_lo), int(a_hi - a_lo) + extra)


def dummy_slot(pslot, grid):
    """The reference's pslot with every slot in the dummy row read as the
    dummy slot: it ranks the invalid lanes within the dummy row, the port
    gives them all its first slot (bin_and_table_plain); neither is read."""
    return np.minimum(np.asarray(pslot), grid.num_cells * grid.capacity)


def active_cells_of(tgrid):
    rank = tgrid.active_rank.numpy()[:-1]
    return np.flatnonzero(rank >= 0)


@pytest.mark.parametrize("mode", ["active", "cells"])
def test_rebuild_sweep_slab_form_matches_reference(mode):
    """K1 with ids, valid and a window: ``active`` is the engine's (the
    cell window with its active slice: a particle outside it is unswept),
    ``cells`` the window alone (no active list: outside emits nothing and
    is not unswept)."""
    cfg, jgrid, tgrid, arrays, ids, valid, _ = slab_lanes()
    n = arrays["pos"].shape[0]
    cr = cfg.physics.collision_range
    reach_j, _ = jpairs.reach_radii(jnp.asarray(arrays["vel"]), 8.0 * cr,
                                    cfg.dt, K, 0.5 * jgrid.cell_size)
    reach = np.array(reach_j)
    cell_window, active_window = windows(jgrid, active_cells_of(tgrid))
    jactive = active_window if mode == "active" else None
    cands_j, overflow_j, (pslot_j, _, unswept_j) = \
        jcollide.cell_candidate_search(
            jnp.asarray(arrays["pos"]), jgrid, reach=reach_j, top_k=4,
            ids=jnp.asarray(ids), valid=jnp.asarray(valid),
            cell_window=cell_window, one_sided=True, half_shell=True,
            active_window=jactive, occupancy_skip=False)

    pos = torch.from_numpy(arrays["pos"])
    tvalid = torch.from_numpy(valid)
    _, table, pslot, overflow = tcollide.bin_and_table_plain(pos, tgrid,
                                                             valid=tvalid)
    cands, unswept, _, _ = tcollide.rebuild_sweep_plain(
        pos, torch.from_numpy(reach), table, pslot, tgrid, 4, chunk=1000,
        ids=torch.from_numpy(ids), valid=tvalid, cell_window=cell_window,
        active_window=jactive)

    assert int(overflow) == int(overflow_j)
    np.testing.assert_array_equal(pslot.numpy(), dummy_slot(pslot_j, tgrid))
    np.testing.assert_array_equal(unswept.numpy(), np.asarray(unswept_j))
    got, want = cands.numpy(), np.asarray(cands_j)
    for i in np.nonzero((got != want).any(axis=1))[0]:
        for j in set(got[i]) ^ set(want[i]):
            if j < 0:
                continue
            d2 = float(np.sum((arrays["pos"][i] - arrays["pos"][j]) ** 2))
            th2 = float((reach[i] + reach[j]) ** 2)
            assert abs(d2 - th2) <= np.spacing(th2), (i, j)
    emitted = (got >= 0).any(axis=1)
    assert emitted.sum() > 50 and not emitted[~valid].any()
    assert valid[got[got >= 0]].all()
    # The own-cell rule is by id: some emitter lists a lower lane.
    assert (got < np.arange(n)[:, None]).any() and (got >= 0).any()
    assert unswept.any() == (mode == "active")
    assert (~emitted[valid]).sum() > n // 4      # the window cut the rest


def test_emit_pairs_slab_form_matches_reference():
    """K5 with valid lanes against ``rebuild_finish(ids, valid_lanes)``:
    the invalid lanes' candidates, clips, unswept flags and dropped slots
    all set, and none of it reaching the list, hot, pending1 or spill."""
    rng = np.random.default_rng(22)
    n, top_k = 5125, 4
    cands = np.sort(rng.integers(0, n, (n, top_k)), axis=1).astype(np.int32)
    width = rng.integers(0, top_k + 1, (n, 1))
    cands = np.where(np.arange(top_k) < width, cands, -1).astype(np.int32)
    dummy = 5 * n
    pslot0 = rng.integers(0, dummy + 2, n).astype(np.int32)
    clipped = rng.uniform(size=n) < 0.05
    unswept = rng.uniform(size=n) < 0.05
    valid = rng.uniform(size=n) < 0.8
    pslot0[np.flatnonzero(~valid)[::5]] = dummy     # binned to the dummy
    ids = rng.permutation(n).astype(np.int32)
    cap = int((cands[valid] >= 0).sum()) - 100
    grid = dataclasses.make_dataclass("G", ["num_cells", "capacity"])(
        dummy // 5, 5)
    pcfg = dataclasses.make_dataclass("P", ["pair_capacity", "top_k"])(
        cap, top_k)
    old = dataclasses.make_dataclass("O", ["overflow", "spill"])(
        jnp.int32(11), jnp.int32(7))
    want = jpairs.rebuild_finish(
        jnp.asarray(cands), jnp.int32(3), jnp.asarray(pslot0), None,
        jnp.asarray(unswept), jnp.asarray(clipped), old, grid, pcfg, n,
        ids=jnp.asarray(ids), valid_lanes=jnp.asarray(valid))
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    got = tpairs.emit_pairs_plain(
        torch.from_numpy(cands), torch.from_numpy(pslot0),
        torch.from_numpy(clipped), torch.from_numpy(unswept), i32(3),
        i32(11), i32(7), dummy, cap, valid_lanes=torch.from_numpy(valid))
    for name, g in zip(("a", "b", "cursor", "hot", "pending1", "overflow",
                        "spill"), got):
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    a, hot = got[0].numpy(), got[3].numpy()
    assert valid[a[a < n]].all() and not hot[~valid].any() and hot.any()
    assert int(got[5]) > 11       # the capacity cut the list
    # Without valid_lanes the invalid lanes would count: they are there.
    assert ((cands[~valid] >= 0).any() and clipped[~valid].any()
            and (pslot0[~valid] >= dummy).any())


def slab_rebuild(seed=3):
    """A rebuilt slab on both sides: the JAX ``rebuild`` with ids, valid
    lanes and windows (6 planes), and the port's.  Returns (cfg, jgrid,
    tgrid, arrays, ids, valid, rng, jplist, tplist, pcfg)."""
    cfg, jgrid, tgrid, arrays, ids, valid, rng = slab_lanes(seed)
    n = arrays["pos"].shape[0]
    pcfg = pair_config()
    cell_window, active_window = windows(jgrid, active_cells_of(tgrid))
    old = jpairs.PairList.init(n, jgrid, to_jax_pcfg(pcfg), jnp.float64,
                               num_planes=6)
    jplist = jpairs.rebuild(
        JState(**{k: jnp.asarray(v) for k, v in arrays.items()}), jgrid,
        to_jax_pcfg(pcfg), cfg.physics.collision_range, cfg.dt, old,
        ids=jnp.asarray(ids), valid_lanes=jnp.asarray(valid),
        cell_window=cell_window, active_window=active_window)
    state, _ = convert.state_from_numpy(arrays, "cpu", torch.float64)
    told = tpairs.PairList.init(n, tgrid, pcfg, torch.float64, "cpu")
    tplist = tpairs.rebuild(
        state, tgrid, pcfg, cfg.physics.collision_range, cfg.dt, told,
        ids=torch.from_numpy(ids), valid_lanes=torch.from_numpy(valid),
        cell_window=cell_window, active_window=active_window)
    return cfg, jgrid, tgrid, arrays, ids, valid, rng, jplist, tplist, pcfg


def to_port_plist(jplist, grid):
    arrays = {f.name: np.asarray(getattr(jplist, f.name))
              for f in dataclasses.fields(jplist)}
    arrays["pslot0"] = dummy_slot(arrays["pslot0"], grid)
    return convert.pairlist_from_numpy(arrays, grid.capacity, "cpu",
                                       torch.float64)


def test_rebuild_slab_form_matches_reference():
    """K2 + K1 + K5 on a slab's lanes: every PairList field exact against
    the reference's 6-plane list (its id plane is ids[idx0])."""
    _, _, tgrid, arrays, ids, valid, _, jplist, tplist, _ = slab_rebuild()
    n = arrays["pos"].shape[0]
    assert_pairlists_equal(tplist, to_port_plist(jplist, tgrid), n)
    planes = np.asarray(jplist.mega0).reshape(-1, 6, tgrid.capacity)
    idx0 = tplist.idx0.numpy()
    real = idx0 < n
    np.testing.assert_array_equal(planes[:, 4][real], ids[idx0[real]])
    assert int(tplist.cursor) > 0 and tplist.hot.any()
    assert not tplist.hot.numpy()[~valid].any()


@pytest.mark.parametrize("event_capacity", [8192, 16])
def test_test_and_resolve_slab_form_matches_reference(event_capacity):
    """K3 with ids and a local mask on a rebuilt slab list with reversed
    duplicates appended: the match by id, every lane updated, only local
    lanes staged, each pair counted on the side of its lower id."""
    cfg, _, _, arrays, ids, valid, rng, jplist, _, _ = slab_rebuild()
    n = arrays["pos"].shape[0]
    cr = cfg.physics.collision_range
    a, b = np.array(jplist.a), np.array(jplist.b)
    live_n = int(jplist.cursor)
    a[live_n:live_n + 300], b[live_n:live_n + 300] = b[:300], a[:300]
    # Ghost lanes: a band of the valid lanes.
    local = valid & (rng.uniform(size=n) < 0.7)
    pending_mask = (rng.uniform(size=n) < 0.1) & local
    pending_vals = np.where(pending_mask[:, None],
                            rng.uniform(0, 1e-6, (n, 4)), 0.0)
    jplist.a, jplist.b = jnp.asarray(a), jnp.asarray(b)
    jmeas = JMeasurements.zeros(200, np.float64, num_particles=n)
    jmeas.pending_vals = jnp.asarray(pending_vals)
    jmeas.pending_mask = jnp.asarray(pending_mask)
    want = jpairs.test_and_resolve(
        JState(**{k: jnp.asarray(v) for k, v in arrays.items()}), jmeas,
        jplist, cr, 200, 1e-6, event_capacity, ids=jnp.asarray(ids),
        local_mask=jnp.asarray(local))
    tstate, _ = convert.state_from_numpy(arrays, "cpu", torch.float64)
    tmeas = dataclasses.replace(
        TMeasurements.zeros(200, torch.float64, num_particles=n),
        pending_vals=torch.from_numpy(pending_vals.copy()),
        pending_mask=torch.from_numpy(pending_mask.copy()))
    got = tpairs.test_and_resolve_plain(
        tstate, tmeas, torch.from_numpy(a), torch.from_numpy(b), cr,
        event_capacity, ids=torch.from_numpy(ids),
        local_mask=torch.from_numpy(local))
    jstate, jm, ncol_j, mask_j = want
    tstate, tmeas, ncol_t, mask_t = got
    assert int(ncol_t) == int(ncol_j)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    for f in ("collision_count", "overflow_count"):
        assert int(getattr(tmeas, f)) == int(getattr(jm, f)), f
    np.testing.assert_array_equal(tmeas.pending_mask.numpy(),
                                  np.asarray(jm.pending_mask))
    np.testing.assert_allclose(tmeas.pending_vals.numpy(),
                               np.asarray(jm.pending_vals), rtol=1e-12,
                               atol=1e-18)
    for f in ("pos", "vel", "paths"):
        ref = np.asarray(getattr(jstate, f))
        np.testing.assert_allclose(getattr(tstate, f).numpy(), ref,
                                   rtol=1e-12,
                                   atol=1e-12 * np.abs(ref[valid]).max())
    np.testing.assert_array_equal(tstate.has_collided.numpy(),
                                  np.asarray(jstate.has_collided))
    collided = mask_t.numpy()
    if event_capacity == 8192:
        # Ghost lanes resolved, and some pair counted on neither side here.
        assert collided[~local].any() and collided[local].any()
        assert int(ncol_t) < collided.sum() // 2
    else:
        assert int(tmeas.overflow_count) > 0


@pytest.mark.parametrize("copies", [False, True])
def test_research_dirty_slab_form_matches_reference(copies):
    """K4 with ids after the particles moved: "not itself" by global id.
    With ``copies`` two lanes hold a copy of another lane's particle (its
    id, its position): neither finds its twin, which a lane test would."""
    cfg, jgrid, tgrid, arrays, ids, valid, rng, _, _, pcfg = slab_rebuild()
    n = arrays["pos"].shape[0]
    cr, dt = cfg.physics.collision_range, cfg.dt
    lanes = np.flatnonzero(valid)
    if copies:
        src, dst = lanes[10:12], np.flatnonzero(~valid)[:2]
        ids = ids.copy()
        for s_, d_ in zip(src, dst):
            arrays["pos"][d_], arrays["vel"][d_] = (arrays["pos"][s_],
                                                   arrays["vel"][s_])
            ids[d_], valid[d_] = ids[s_], True
    old = jpairs.PairList.init(n, jgrid, to_jax_pcfg(pcfg), jnp.float64,
                               num_planes=6)
    cell_window, active_window = windows(jgrid, active_cells_of(tgrid))
    jplist = jpairs.rebuild(
        JState(**{k: jnp.asarray(v) for k, v in arrays.items()}), jgrid,
        to_jax_pcfg(pcfg), cr, dt, old, ids=jnp.asarray(ids),
        valid_lanes=jnp.asarray(valid), cell_window=cell_window,
        active_window=active_window)
    moved = dict(arrays)
    moved["pos"] = np.where(valid[:, None],
                            arrays["pos"] + 3 * dt * arrays["vel"],
                            arrays["pos"])
    moved["vel"] = arrays["vel"].copy()
    dirty = np.sort(rng.choice(lanes[20:], 300, replace=False))
    if copies:
        dirty = np.union1d(dirty, np.concatenate([src, dst]))
        moved["pos"][dst] = moved["pos"][src]
    bump = np.zeros(n, bool)
    bump[dirty[::2]] = True
    moved["vel"][dirty[::2]] += 120.0
    dirty_idx = np.full(pcfg.research_capacity, n, np.int32)
    dirty_idx[:dirty.size] = dirty
    tplist = to_port_plist(jplist, tgrid)
    jnew, lost_j, latent_j = jpairs.research_dirty(
        JState(**{k: jnp.asarray(v) for k, v in moved.items()}), jplist,
        jnp.asarray(dirty_idx), jnp.asarray(bump), jgrid, to_jax_pcfg(pcfg),
        cr, dt, ids=jnp.asarray(ids))
    tstate, _ = convert.state_from_numpy(moved, "cpu", torch.float64)
    tnew, lost_t, latent_t = tpairs.research_dirty_plain(
        tstate, tplist, torch.from_numpy(dirty_idx), torch.from_numpy(bump),
        tgrid, pcfg, cr, dt, ids=torch.from_numpy(ids))
    assert_pairlists_equal(tnew, to_port_plist(jnew, tgrid), n)
    assert bool(lost_t) == bool(lost_j)
    np.testing.assert_array_equal(latent_t.numpy(), np.asarray(latent_j))
    assert int(tnew.cursor) > int(tplist.cursor)
    new_a = tnew.a.numpy()[:int(tnew.cursor)]
    new_b = tnew.b.numpy()[:int(tnew.cursor)]
    assert (ids[new_a] != ids[new_b]).all()
    if copies:
        for s_, d_ in zip(src, dst):
            pair = ((new_a == s_) & (new_b == d_)) | (
                (new_a == d_) & (new_b == s_))
            assert not pair.any()


# --------------------------------------------------------------------------
# (b) The 4-slab pairs run against the JAX engine, step by step
# --------------------------------------------------------------------------

PAIRS = dict(narrowphase="pairs", rebuild_interval=4, steps_per_epoch=4)
PAIR_METRICS = ("rebuilt", "latent_full", "teleports", "latent_research")


def speed_tie_lanes(before, after, windows) -> int:
    """Lanes holding a particle whose velocity the step changed but whose
    speed (the port's formula) it moved by at most one ulp: its own lane
    and each ghost of it the frozen export lists made.  The reference's
    bump mask compares speeds from XLA's FMA-contracted sum of squares, so
    such a particle can read as changed on one side only, on each lane that
    holds it (test_torch_engine.py; a dirty lane is only re-searched)."""
    _, fields = live(before)
    vel0 = fields["vel"]
    count = 0
    for (st, valid, gid), win in zip(after, windows):
        v0, v1 = vel0[gid[valid].long()], st.vel[valid]
        s0 = tmeasure.speed(v0).numpy()
        s1 = tmeasure.speed(v1).numpy()
        tie = torch.zeros(valid.shape[0], dtype=torch.bool)
        tie[valid] = torch.from_numpy(
            (v0 != v1).any(dim=-1).numpy()
            & (np.abs(s1 - s0) <= np.spacing(s0)))
        count += int(tie.sum())
        for idx, flag in ((win.up_idx, win.up_flag), (win.dn_idx,
                                                      win.dn_flag)):
            count += int(tie[idx[flag].long()].sum())
    return count


@pytest.mark.parametrize("energized", [True, False],
                         ids=["energized", "specular"])
def test_sharded_pairs_matches_reference_step_by_step(energized):
    """Steps on 4 slabs from the reference's split state, with pairs
    planted across every face and the reference's uniforms: twelve
    energized (three windows, so two rebuilds migrate what the windows
    carried across the faces), five specular (one such rebuild).  After
    every step, slab by slab: valid, gid, every counter, the histogram,
    the staging mask and every metric exact; the state within the sweep
    test's bound."""
    n, steps = 3000, 12 if energized else 5
    jcfg = amc.temperature_pore_config if energized else amc.PoreConfig
    jsim = jshard.ShardedSimulation(
        amc.make_workload(jcfg(engine=JEngine(
            dtype="float64", broadphase="cells", **PAIRS)).scaled_to(n)),
        mesh=make_mesh(SLABS))
    tcfg, tsim = port_sharded(n, energized, scaled=True, **PAIRS)
    for f in ("shard_capacity", "pairs_halo_capacity",
              "pairs_migration_capacity", "pairs_cell_window",
              "pairs_active_window"):
        assert getattr(tsim.plan, f) == getattr(jsim.plan, f), f
    assert dataclasses.asdict(tsim.pcfg) == {
        k: v for k, v in dataclasses.asdict(jsim._pairs_pcfg).items()
        if k not in ("bf16_hit", "occupancy_skip")}
    jstate, jmeasure, run_key = jsim.init()
    jstate, planted = plant_cross_face_pairs(
        jstate, jsim.plan, tcfg.physics.collision_range)
    tstate, tmeasure = to_port(jstate, jmeasure)
    cap = tsim.plan.shard_capacity
    assert tmeasure[0].pending_vals.shape == (
        cap + 2 * tsim.plan.pairs_halo_capacity, 4)

    def draw(shard, i):
        key = jax.random.fold_in(jax.random.fold_in(run_key, shard), i)
        return torch.from_numpy(np.array(
            jax.random.uniform(key, (cap, 2), jnp.float64)))

    start = owner_by_gid(tstate)
    pairs = hits = 0
    for i in range(steps):
        before = tstate
        jstate, jmeasure, jmet = jsim.run(
            num_steps=1, state=jstate, measure=jmeasure, run_key=run_key,
            start_step=i)
        tstate, tmeasure, tmet = tsim.run(
            num_steps=1, state=tstate, measure=tmeasure, start_step=i,
            draw=draw)
        assert_slabs_match(i, jstate, jmeasure, tstate, tmeasure)
        for f in EXACT_METRICS + PAIR_METRICS:
            assert int(getattr(tmet, f)[0]) == int(
                np.asarray(getattr(jmet, f))[0]), (i, f)
        gap = abs(int(tmet.dirty_count[0])
                  - int(np.asarray(jmet.dirty_count)[0]))
        assert gap <= speed_tie_lanes(before, tstate, tsim._windows), (
            i, "dirty_count")
        for f in LEDGER:
            assert float(getattr(tmet, f)[0]) == pytest.approx(
                float(np.asarray(getattr(jmet, f))[0]), rel=1e-9, abs=1e-35)
        pairs += int(tmet.collisions[0]) - int(tmet.wall_hits[0])
        hits += int(tmet.wall_hits[0])
        if i == 0:      # the planted pairs collide in the first step
            assert pairs >= planted == 2 * (SLABS - 1)
        assert int(tmet.rebuilt[0]) == (i % 4 == 0)
    assert pairs > planted and hits > 0
    gids, _ = live(tstate)
    assert torch.equal(gids, torch.arange(n, dtype=torch.int32))
    assert int((owner_by_gid(tstate) != start).sum()) > 0
    total = tsim.finalize_measure(tmeasure)
    want = jsim.finalize_measure(jmeasure)
    for f in COUNTERS:
        assert int(getattr(total, f)) == int(getattr(want, f)), f
    assert int(total.collision_count) == pairs + hits
    assert int(total.overflow_count) == int(total.halo_trunc_count) == 0


# --------------------------------------------------------------------------
# (c) The reference's own sharded-pairs tests, on the port
# --------------------------------------------------------------------------


def gather_by_gid(state, n):
    gids, fields = live(state)
    assert torch.equal(gids, torch.arange(n, dtype=torch.int32))
    return fields


def test_sharded_pairs_matches_sharded_sweep_bitwise_specular():
    """Specular pore (no random draw after the init): the sharded pairs
    engine gives the sharded sweep's trajectories bit for bit -- the list
    covers every collision pair between rebuilds, the ghosts mirror their
    owners every step, and the resolve is the same IEEE expression
    (tests/test_sharding.py:156)."""
    n, steps = 3000, 12
    _, sweep = port_sharded(n, energized=False)
    state_s, m_s, _ = sweep.run(num_steps=steps)
    _, pairs = port_sharded(n, energized=False, **PAIRS)
    state_p, m_p, met_p = pairs.run(num_steps=steps)
    a, b = gather_by_gid(state_s, n), gather_by_gid(state_p, n)
    for f in ("pos", "vel"):
        assert torch.equal(a[f], b[f]), f
    tot_s, tot_p = sweep.finalize_measure(m_s), pairs.finalize_measure(m_p)
    assert int(tot_s.collision_count) == int(tot_p.collision_count) > 0
    assert int(tot_p.overflow_count) == 0
    assert met_p.rebuilt.tolist() == [1, 0, 0, 0] * 3


def test_sharded_pairs_energized_statistics_and_conservation():
    """Energized pore, sharded pairs against one card's pairs: every
    particle kept, no capacity overflow, collision totals statistically
    equal (the random draws differ), the cold wall's energy ledger of one
    sign (tests/test_sharding.py:182)."""
    n, steps = 6000, 15
    engine = dict(narrowphase="pairs", rebuild_interval=5, steps_per_epoch=5)
    cfg, sim = port_sharded(n, **engine)
    state, measure, metrics = sim.run(num_steps=steps)
    gather_by_gid(state, n)
    tot = sim.finalize_measure(measure)
    assert int(tot.overflow_count) == 0 and int(tot.err_count) == 0
    single = amt.Simulation(amt.make_workload(cfg), device="cpu")
    _, m1, met1 = single.run(num_steps=steps)
    c1, c2 = int(m1.collision_count), int(tot.collision_count)
    assert abs(c1 - c2) <= 5 * max(np.sqrt(max(c1, c2)), 3.0)
    e1, e2 = float(met1.energy_cold.sum()), float(metrics.energy_cold.sum())
    assert np.sign(e1) == np.sign(e2) != 0


# --------------------------------------------------------------------------
# (e) One pairs slab against the single-card pairs engine
# --------------------------------------------------------------------------


@pytest.mark.parametrize("energized", [False, True],
                         ids=["specular", "energized"])
def test_one_pairs_slab_equals_single_card_engine_bitwise(energized):
    """One slab has no ghosts and no migration: its lanes are the single
    card's particles in the same order, so the rebuilt lists hold the same
    entries and the state, the measurements and the collision metrics
    must not move a bit against ``Simulation`` in pairs mode."""
    cfg = sized_port_config(3000, energized)
    wl = amt.make_workload(cfg)
    single = amt.Simulation(wl, device="cpu")
    sharded = amt.ShardedSimulation(wl, n_shards=1, devices=["cpu"])
    state, measure, gen = single.init()
    n, cap = state.num_particles, sharded.plan.shard_capacity
    assert cap > n
    uniforms = torch.rand((10, cap, 2), generator=gen, dtype=torch.float64)
    s1, m1, met1 = single.run(10, state=state, measure=measure,
                              draw=lambda i: uniforms[i, :n])
    slabs, ms, metk = sharded.run(
        10, state=sharded.shard_state(state),
        measure=sharded.zero_measurements(),
        draw=lambda s, i: uniforms[i])
    (st, valid, gid), = slabs
    assert int(valid.sum()) == n and torch.equal(
        gid[:n], torch.arange(n, dtype=torch.int32))
    for f in ("pos", "vel", "paths", "has_collided"):
        assert torch.equal(getattr(st, f)[:n], getattr(s1, f)), f
    total = sharded.finalize_measure(ms)
    for f in ("hist", "path_sum", "path_count", "collision_count",
              "err_count", "overflow_count"):
        assert torch.equal(getattr(total, f), getattr(m1, f)), f
    for f in EXACT_METRICS + LEDGER + ("rebuilt",):
        assert torch.equal(getattr(metk, f), getattr(met1, f)), f
    assert int(m1.collision_count) > int(met1.wall_hits.sum()) > 0
    assert not st.paths[n:].any() and not st.has_collided[n:].any()
    assert (st.pos[n:] == tshard.SENTINEL).all()


def sized_port_config(n, energized):
    make = amt.temperature_pore_config if energized else amt.PoreConfig
    return make(num_particles_override=n, engine=amt.EngineConfig(
        dtype="float64", **PAIRS))
