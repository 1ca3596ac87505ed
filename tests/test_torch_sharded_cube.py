"""The sharded cube: the port's ``ShardedSimulation`` on the cube's centred
cell grid, step by step against the JAX cube on one card (the split held
to the JAX sharded engine's), and the pairs narrow phase refused on the
cube alike by both packages (the one grid with a centre never reaches K4,
whose re-search bins without one).

The reference for the trajectory is the JAX one-card cube, not the JAX
sharded one: the cube drifts several collision ranges a step, and the
reference's sharded sweep exchanges ghosts only within a fixed band of
each face, so a particle that crossed a face in the step meets partners
its owner never sees, and one slab resolves a pair the other does not
(``scripts/torch_sharded_cube_energy.py`` measures the kinetic energy
drift this gives the reference).  The port's bands reach past the
farthest crosser (``ShardedSimulation._reach_edges``) and its partner
choice orders by global id, the one-card rule, so its 4 slabs follow the
one-card trajectory.

Tolerances: gid, has_collided, the per-step collisions, the histogram,
path_count and every counter exact; float64 state within 1e-12 relative
to the largest value after a step from the reference's state; the
kinetic energy within 1e-12 relative.  The reference's sharded cube is
run too, to pin the fault the port departs from it for: from the same
state its kinetic energy moves by more than 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import argon_monte_carlo_tpu as amc
import argon_monte_carlo_tpu_torch as amt
from argon_monte_carlo_tpu import engine as jengine
from argon_monte_carlo_tpu.config import EngineConfig as JEngine
from argon_monte_carlo_tpu.parallel import shard as jshard
from argon_monte_carlo_tpu.parallel.mesh import make_mesh
from argon_monte_carlo_tpu.ops import collide as jcollide
from argon_monte_carlo_tpu_torch import convert
from argon_monte_carlo_tpu_torch.ops import collide as tcollide
from test_torch_collide import grids, pore_setup, slab_lanes
from test_torch_sharding import SLABS, live, owner_by_gid, to_port

STATE_FIELDS = ("pos", "vel", "paths", "has_collided")


def cube_configs(n, **engine):
    engine = dict(dict(dtype="float64", broadphase="cells",
                       steps_per_epoch=5), **engine)
    return (amc.CubeConfig(num_particles_override=n,
                           engine=JEngine(**engine)),
            amt.CubeConfig(num_particles_override=n,
                           engine=amt.EngineConfig(**engine)))


def test_sharded_cube_matches_reference_step_by_step():
    """Ten steps of the cube, dilute (12,000 particles in the published
    box), on 4 slabs from the reference's initial state: the split equals
    the JAX sharded engine's, the plan's park point and the grid's centre
    are the box's.  The port runs on its own from that state (gid and
    has_collided by global id, the collisions, the histogram and every
    counter exact each step; particles cross faces every step; the kinetic
    energy kept) and also takes each step from the reference's state
    before it, split afresh (the state after the step within 1e-12): as in
    test_torch_cube.py, collisions amplify a last-bit difference, and the
    free-running states drift past 1e-12 of each other within ten steps."""
    n, steps = 12_000, 10
    jcfg, tcfg = cube_configs(n)
    jone = amc.Simulation(amc.make_workload(jcfg))
    jsharded = jshard.ShardedSimulation(amc.make_workload(jcfg),
                                        mesh=make_mesh(SLABS))
    tsim = amt.ShardedSimulation(amt.make_workload(tcfg), n_shards=SLABS,
                                 devices=["cpu"])
    geom = tcfg.geometry
    assert tsim.plan.park == jsharded.plan.park == (
        geom.lx / 2, geom.ly / 2, geom.lz / 2)
    grid = tsim._grids[torch.device("cpu")]
    assert (grid.center_x, grid.center_y) == (
        jsharded.device_grid.center_x, jsharded.device_grid.center_y) == (
        geom.lx / 2, geom.ly / 2)

    def split(jstate):
        arrays = {f: np.array(getattr(jstate, f)) for f in STATE_FIELDS}
        return tsim.shard_state(convert.state_from_numpy(
            arrays, "cpu", torch.float64)[0])

    jstate, jmeas, run_key = jone.init()
    tstate = split(jstate)
    (jst, jvalid, jgid), _, _ = jsharded.init()
    got = convert.sharded_state_to_numpy(tstate)
    np.testing.assert_array_equal(got["valid"], np.asarray(jvalid))
    np.testing.assert_array_equal(got["gid"], np.asarray(jgid))
    np.testing.assert_array_equal(got["pos"], np.asarray(jst.pos))
    tmeas = tsim.zero_measurements()
    zeros = torch.zeros((tsim.plan.shard_capacity, 2), dtype=torch.float64)

    def energy(state):
        return float((live(state)[1]["vel"] ** 2).sum())

    e0 = energy(tstate)
    moved = 0
    for i in range(steps):
        synced = split(jstate)
        before = owner_by_gid(tstate)
        jstate, jmeas, jmet = jone.run(num_steps=1, state=jstate,
                                       measure=jmeas, run_key=run_key,
                                       start_step=i)
        tstate, tmeas, tmet = tsim.run(num_steps=1, state=tstate,
                                       measure=tmeas, start_step=i,
                                       draw=lambda s, i: zeros)
        sstate, _, _ = tsim.run(num_steps=1, state=synced,
                                measure=tsim.zero_measurements(),
                                start_step=i, draw=lambda s, i: zeros)
        gids, fields = live(tstate)
        assert torch.equal(gids, torch.arange(n, dtype=torch.int32))
        np.testing.assert_array_equal(fields["has_collided"].numpy(),
                                      np.asarray(jstate.has_collided))
        assert int(tmet.collisions[0]) == int(
            np.asarray(jmet.collisions)[0]), i
        total = tsim.finalize_measure(tmeas)
        for f in ("path_count", "collision_count", "err_count",
                  "overflow_count", "hist_drop_count"):
            assert int(getattr(total, f)) == int(getattr(jmeas, f)), (i, f)
        np.testing.assert_array_equal(total.hist.numpy(),
                                      np.asarray(jmeas.hist))
        _, fields = live(sstate)
        for f in ("pos", "vel", "paths"):
            want = np.asarray(getattr(jstate, f))
            np.testing.assert_allclose(fields[f].numpy(), want, rtol=1e-12,
                                       atol=1e-12 * np.abs(want).max(),
                                       err_msg=f"{f}, step {i}")
        np.testing.assert_array_equal(fields["has_collided"].numpy(),
                                      np.asarray(jstate.has_collided))
        moved += int((owner_by_gid(tstate) != before).sum())
    assert int(total.collision_count) > 50 and int(total.path_count) > 0
    assert moved > n // 10
    assert int(total.overflow_count) == int(total.halo_trunc_count) == 0
    assert energy(tstate) == pytest.approx(e0, rel=1e-12)


def test_reference_sharded_cube_loses_the_energy_the_port_keeps():
    """Five steps of the cube (12,000 particles, float64) on 4 slabs from
    the JAX sharded engine's initial state, in both sharded engines: the
    walls are specular and the collisions elastic, so the kinetic energy is
    a constant of the motion.  The reference's changes by more than 1e-5
    relative (a pair resolved on one slab and not on the other); the
    port's stays within 1e-12 (scripts/torch_sharded_cube_energy.py runs
    the published 24,627 particles for longer).  Should the reference be
    repaired, this fails, and the port's test against the one-card cube
    can go back to the sharded one."""
    n, steps = 12_000, 5
    jcfg, tcfg = cube_configs(n, steps_per_epoch=steps)
    jsim = jshard.ShardedSimulation(amc.make_workload(jcfg),
                                    mesh=make_mesh(SLABS))
    tsim = amt.ShardedSimulation(amt.make_workload(tcfg), n_shards=SLABS,
                                 devices=["cpu"])
    jstate, jmeas, run_key = jsim.init()
    tstate, _ = to_port(jstate, jmeas)   # the port's bands are wider
    assert tsim.plan.halo_capacity > jsim.plan.halo_capacity

    def energy(state):
        return float((live(state)[1]["vel"] ** 2).sum())

    e0 = energy(tstate)
    jstate, _, jmet = jsim.run(num_steps=steps, state=jstate, measure=jmeas,
                               run_key=run_key)
    zeros = torch.zeros((tsim.plan.shard_capacity, 2), dtype=torch.float64)
    tstate, _, tmet = tsim.run(num_steps=steps, state=tstate,
                               measure=tsim.zero_measurements(),
                               draw=lambda s, i: zeros)
    st, valid, _ = jstate
    want_e = float((np.asarray(st.vel)[np.asarray(valid)] ** 2).sum())
    assert abs(want_e / e0 - 1) > 1e-5
    assert energy(tstate) == pytest.approx(e0, rel=1e-12)
    assert int(tmet.collisions.sum()) > 20


@pytest.mark.parametrize("k", [1, 8])
def test_pairs_on_the_cube_is_refused_by_both_packages(k):
    """The cube's per-step drift is tens of collision ranges: no top-k
    emission covers its in-reach candidates, and both packages refuse the
    pairs narrow phase there, one card or sharded.  So K4's re-search,
    which bins without the grid's centre, never meets the one grid that
    has one."""
    jcfg, tcfg = cube_configs(None, narrowphase="pairs",
                              rebuild_interval=k)
    jwl, twl = amc.make_workload(jcfg), amt.make_workload(tcfg)
    with pytest.raises(ValueError, match="cannot cover"):
        jengine.pairs_config_for(jwl)
    with pytest.raises(ValueError, match="cannot cover"):
        amt.engine.pairs_config_for(twl)
    with pytest.raises(ValueError, match="cannot cover"):
        jshard.ShardedSimulation(jwl, mesh=make_mesh(SLABS))
    with pytest.raises(ValueError, match="cannot cover"):
        amt.Simulation(twl, device="cpu")
    with pytest.raises(ValueError, match="cannot cover"):
        amt.ShardedSimulation(twl, n_shards=SLABS, devices=["cpu"])


def test_partner_sweep_rank_orders_by_global_id():
    """K9 with ``ids``: the partner is the candidate of the lowest global
    id.  Held against the JAX search run on the same lanes put in id order,
    where the lowest lane is the lowest id (its copies, lanes that repeat
    another's id and place, excluded alike); and it differs from the JAX
    lane rule on these lanes as they lie."""
    cfg, host_grid = pore_setup()
    jgrid, tgrid = grids(host_grid, np.float64, torch.float64)
    pos, ids, valid = slab_lanes(cfg, np.random.default_rng(12), np.float64)
    radius = 3.0 * cfg.physics.collision_range   # several candidates each
    perm = np.argsort(ids, kind="stable")
    want_p, _ = jcollide.cell_partner_search(
        jnp.asarray(pos[perm]), jgrid, radius, ids=jnp.asarray(ids[perm]),
        valid=jnp.asarray(valid[perm]))
    want_p = np.asarray(want_p)
    want = np.full(pos.shape[0], -1)
    want[perm] = np.where(want_p >= 0, perm[np.maximum(want_p, 0)], -1)
    pos_t, ids_t, valid_t = (torch.from_numpy(a) for a in (pos, ids, valid))
    _, table, pslot, _ = tcollide.bin_and_table_plain(pos_t, tgrid,
                                                      valid=valid_t)
    got = tcollide.partner_sweep_plain(pos_t, table, pslot, tgrid, radius,
                                       chunk=1024, ids=ids_t,
                                       valid=valid_t).numpy()
    np.testing.assert_array_equal(got, want)
    by_lane, _ = jcollide.cell_partner_search(
        jnp.asarray(pos), jgrid, radius, ids=jnp.asarray(ids),
        valid=jnp.asarray(valid))
    by_lane = np.asarray(by_lane)
    assert (got >= 0).sum() > 500 and (got != by_lane).sum() > 50
