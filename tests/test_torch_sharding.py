"""The z-slab engine (sweep mode): the port's ``ShardedSimulation`` against
the JAX ``ShardedSimulation`` on 4 virtual CPU devices, and the port's
versions of the reference's own sharding tests (tests/test_sharding.py).

``make_shard_plan`` is host arithmetic on both sides: every field equal.
The engines start from the reference's split state (carried across with
``convert.sharded_state_from_numpy``) and the port gets the reference's
per-step uniforms -- slab s, step i draws from ``fold_in(fold_in(run_key,
s), i)`` -- through ``draw``, so the trajectories are the same up to
rounding.  Checked after every one of 10 steps, slab by slab: ``valid``,
``gid``, ``has_collided``, every counter (``halo_trunc_count`` and
``overflow_count`` among them), the histogram and the per-step integer
metrics exact; float64 state within 1e-12 relative; ``path_sum`` and the
ledger, sums over a few events taken in another order, within 1e-9.

The port's K9 takes the candidate of the lowest global id, the reference's
the lowest lane (an order two slabs do not share); the step-by-step test
counts, on every slab and step, the lanes where the two rules pick
different partners, and holds that count to zero, so its equality with the
reference is one of the engines and not of the rules.
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
from argon_monte_carlo_tpu.parallel import shard as jshard
from argon_monte_carlo_tpu.parallel.mesh import make_mesh
from argon_monte_carlo_tpu_torch import convert
from argon_monte_carlo_tpu_torch.parallel import shard as tshard

SLABS = 4
CPUS = ["cpu"] * SLABS
STATE_FIELDS = ("pos", "vel", "paths", "has_collided")
COUNTERS = ("path_count", "collision_count", "err_count", "overflow_count",
            "hist_drop_count", "hot_spill_count", "halo_trunc_count")
EXACT_METRICS = ("collisions", "wall_hits", "oob_after_walls",
                 "oob_after_pairs")
LEDGER = ("momentum_z", "energy_hot", "energy_cold")


def sized(make, n, scaled, engine):
    """``n`` particles in the published geometry (dilute, as the
    reference's sharding tests run it) or, ``scaled``, at the published
    density in a geometry shrunk to hold them."""
    if scaled:
        return make(engine=engine).scaled_to(n)
    return make(num_particles_override=n, engine=engine)


def port_config(n, energized=True, scaled=False, **engine):
    engine = dict(dict(dtype="float64", steps_per_epoch=5), **engine)
    make = amt.temperature_pore_config if energized else amt.PoreConfig
    return sized(make, n, scaled, amt.EngineConfig(**engine))


def port_sharded(n=4000, energized=True, n_shards=SLABS, scaled=False,
                 **engine):
    cfg = port_config(n, energized, scaled, **engine)
    return cfg, amt.ShardedSimulation(amt.make_workload(cfg),
                                      n_shards=n_shards, devices=["cpu"])


def reference_config(n, energized=True, scaled=False, **engine):
    engine = dict(dict(dtype="float64", broadphase="cells",
                       steps_per_epoch=5), **engine)
    make = amc.temperature_pore_config if energized else amc.PoreConfig
    return sized(make, n, scaled, JEngine(**engine))


# --------------------------------------------------------------------------
# The plan
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards,target,engine", [
    (2, 4000, {}), (4, 4000, {}), (8, 4000, {}), (4, 200_000, {}),
    (4, 20_000, dict(narrowphase="pairs", rebuild_interval=8)),
    (4, "cube", {}),
])
def test_shard_plan_equals_reference(n_shards, target, engine):
    """Every field of the plan, the pairs mode's too, for 2, 4 and 8
    slabs, and the cube's (its volume profile, no active list, its park
    point at the box's centre) at its published size -- but the cube's
    halo capacity, which the port widens to hold a step's drift (the
    reference's bands miss a crosser's partners, and its sharded cube
    loses energy for it; test_torch_sharded_cube.py)."""
    if target == "cube":
        jcfg = amc.CubeConfig(engine=JEngine(broadphase="cells"))
        tcfg = amt.CubeConfig(engine=amt.EngineConfig(broadphase="cells"))
    else:
        jcfg = amc.temperature_pore_config(engine=JEngine(
            broadphase="cells", **engine)).scaled_to(target)
        tcfg = amt.temperature_pore_config(engine=amt.EngineConfig(
            **engine)).scaled_to(target)
    jwl, twl = amc.make_workload(jcfg), amt.make_workload(tcfg)
    from argon_monte_carlo_tpu.engine import build_grids as jbuild
    jgrid, _ = jbuild(jwl)
    tgrid, _ = amt.engine.build_grids(twl, "cpu")
    want = jshard.make_shard_plan(jwl, n_shards, jgrid)
    got = tshard.make_shard_plan(twl, n_shards, tgrid)
    names = [f.name for f in dataclasses.fields(jshard.ShardPlan)]
    assert names == [f.name for f in dataclasses.fields(tshard.ShardPlan)]
    for name in names:
        a, b = getattr(got, name), getattr(want, name)
        if target == "cube" and name == "halo_capacity":
            assert a > 4 * b, (a, b)
        elif b is None:
            assert a is None, name
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert type(a) is type(b) and a == b, name
    assert got.slab_z.shape == (n_shards + 1,)
    assert (np.diff(got.slab_z) > 0).all()


# --------------------------------------------------------------------------
# Against the JAX engine, step by step
# --------------------------------------------------------------------------


def plant_cross_face_pairs(jstate, plan, cr):
    """Two overlapping, approaching pairs across every interior face: one
    particle just below the face in the lower slab, its partner just above
    in the upper slab, so each slab meets the other's particle only as a
    ghost.  Returns the state and the number of pairs."""
    st, valid, gid = jstate
    cap = plan.shard_capacity
    pos, vel = np.array(st.pos), np.array(st.vel)
    planted = 0
    for face in range(1, plan.n_shards):
        z = plan.slab_z[face]
        for k in range(2):
            a, b = (face - 1) * cap + k, face * cap + 2 + k
            assert valid[a] and valid[b]
            x = (2 * k - 1) * 5 * cr
            pos[a], vel[a] = (x, 0.0, z - 0.3 * cr), (0.0, 0.0, 300.0)
            pos[b], vel[b] = (x, 0.0, z + 0.3 * cr), (0.0, 0.0, -300.0)
            planted += 1
    st = dataclasses.replace(st, pos=jnp.asarray(pos), vel=jnp.asarray(vel))
    return (st, valid, gid), planted


def to_port(jstate, jmeasure):
    st, valid, gid = jstate
    arrays = {f: np.asarray(getattr(st, f)) for f in STATE_FIELDS}
    arrays.update(valid=np.asarray(valid), gid=np.asarray(gid))
    arrays.update({f: np.asarray(getattr(jmeasure, f)) for f in
                   ("hist", "path_sum", "pending_vals", "pending_mask")
                   + COUNTERS})
    return convert.sharded_state_from_numpy(arrays, CPUS, torch.float64)


def assert_slabs_match(step, jstate, jmeasure, tstate, tmeasure):
    """Every per-slab array of both engines after a step."""
    got = convert.sharded_state_to_numpy(tstate, tmeasure)
    st, valid, gid = jstate
    want_valid = np.asarray(valid)
    np.testing.assert_array_equal(got["valid"], want_valid,
                                  err_msg=f"valid, step {step}")
    np.testing.assert_array_equal(got["gid"], np.asarray(gid),
                                  err_msg=f"gid, step {step}")
    np.testing.assert_array_equal(got["has_collided"],
                                  np.asarray(st.has_collided))
    for f in ("pos", "vel", "paths"):
        want = np.asarray(getattr(st, f))
        scale = np.abs(want[want_valid]).max()
        np.testing.assert_allclose(got[f], want, rtol=1e-12,
                                   atol=1e-12 * scale,
                                   err_msg=f"{f}, step {step}")
    for f in COUNTERS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jmeasure, f)),
                                      err_msg=f"{f}, step {step}")
    np.testing.assert_array_equal(got["hist"], np.asarray(jmeasure.hist))
    np.testing.assert_array_equal(got["pending_mask"],
                                  np.asarray(jmeasure.pending_mask))
    np.testing.assert_allclose(got["path_sum"], np.asarray(jmeasure.path_sum),
                               rtol=1e-9)


@pytest.mark.parametrize("energized", [True, False],
                         ids=["energized", "specular"])
def test_sharded_sweep_matches_reference_step_by_step(energized,
                                                      monkeypatch):
    """One step, then ten, on 4 slabs from the reference's split state
    (with pairs planted across every face) and its own uniforms; on every
    slab and step the partners K9 picks by lowest id are the ones the
    reference's lowest-lane rule picks on the same lanes."""
    n, steps = 3000, 10
    sweep = amt.ops.collide.partner_sweep
    rule_diffs = []

    def partner_sweep(pos, table, pslot, grid, radius, ids=None, valid=None,
                      cell_window=None):
        by_id = sweep(pos, table, pslot, grid, radius, ids=ids, valid=valid,
                      cell_window=cell_window)
        # A slab holds each id once (4 slabs: the bands come from two other
        # slabs), so the lane index can stand for the id in the
        # self-exclusion; without ids K9 orders by lane, the reference's rule.
        held = ids[valid]
        assert torch.unique(held).numel() == held.numel()
        by_lane = sweep(pos, table, pslot, grid, radius, valid=valid,
                        cell_window=cell_window)
        rule_diffs.append(int((by_id != by_lane).sum()))
        return by_id

    monkeypatch.setattr(amt.ops.collide, "partner_sweep", partner_sweep)
    jsim = jshard.ShardedSimulation(
        amc.make_workload(reference_config(n, energized, scaled=True)),
        mesh=make_mesh(SLABS))
    tcfg, tsim = port_sharded(n, energized, scaled=True)
    for f in ("shard_capacity", "halo_capacity", "migration_capacity",
              "cell_window"):
        assert getattr(tsim.plan, f) == getattr(jsim.plan, f)
    jstate, jmeasure, run_key = jsim.init()
    jstate, planted = plant_cross_face_pairs(
        jstate, jsim.plan, tcfg.physics.collision_range)
    tstate, tmeasure = to_port(jstate, jmeasure)
    cap = tsim.plan.shard_capacity
    assert tmeasure[0].pending_vals.shape == (
        cap + 2 * tsim.plan.halo_capacity, 4)

    # The host split of the port equals the reference's.
    _, fields = live(tstate)
    resplit = tsim.shard_state(amt.state.ParticleState(**fields))
    for (st, valid, gid), (st2, valid2, gid2) in zip(tstate, resplit):
        assert torch.equal(valid, valid2) and torch.equal(gid, gid2)
        assert torch.equal(st.pos, st2.pos) and torch.equal(st.vel, st2.vel)

    def draw(shard, i):
        key = jax.random.fold_in(jax.random.fold_in(run_key, shard), i)
        return torch.from_numpy(np.array(
            jax.random.uniform(key, (cap, 2), jnp.float64)))

    start = owner_by_gid(tstate)
    pairs = hits = 0
    for i in range(steps):
        jstate, jmeasure, jmet = jsim.run(
            num_steps=1, state=jstate, measure=jmeasure, run_key=run_key,
            start_step=i)
        tstate, tmeasure, tmet = tsim.run(
            num_steps=1, state=tstate, measure=tmeasure, start_step=i,
            draw=draw)
        assert rule_diffs == [0] * SLABS, (i, rule_diffs)
        rule_diffs.clear()
        assert_slabs_match(i, jstate, jmeasure, tstate, tmeasure)
        for f in EXACT_METRICS:
            assert int(getattr(tmet, f)[0]) == int(
                np.asarray(getattr(jmet, f))[0]), (i, f)
        for f in LEDGER:
            assert float(getattr(tmet, f)[0]) == pytest.approx(
                float(np.asarray(getattr(jmet, f))[0]), rel=1e-9, abs=1e-35)
        pairs += int(tmet.collisions[0]) - int(tmet.wall_hits[0])
        hits += int(tmet.wall_hits[0])
        if i == 0:      # the planted pairs collide in the first step
            assert pairs >= planted == 2 * (SLABS - 1)
    assert pairs > planted and hits > 0
    # Particles changed slab on the way, and totals agree.
    gids, _ = live(tstate)
    assert torch.equal(gids, torch.arange(n, dtype=torch.int32))
    assert int((owner_by_gid(tstate) != start).sum()) > 0
    total = tsim.finalize_measure(tmeasure)
    want = jsim.finalize_measure(jmeasure)
    for f in COUNTERS:
        assert int(getattr(total, f)) == int(getattr(want, f)), f
    np.testing.assert_array_equal(total.hist.numpy(), np.asarray(want.hist))
    assert int(total.collision_count) == pairs + hits
    assert int(total.overflow_count) == int(total.halo_trunc_count) == 0


# --------------------------------------------------------------------------
# The reference's own sharding tests, on the port
# --------------------------------------------------------------------------


def live(state):
    """(gids, ParticleState fields of the live lanes) in gid order."""
    gids = torch.cat([g[v] for _, v, g in state])
    order = torch.argsort(gids)
    fields = {f: torch.cat([getattr(st, f)[v] for st, v, _ in state])[order]
              for f in STATE_FIELDS}
    return gids[order], fields


def owner_by_gid(state):
    """The slab of each live particle, in gid order."""
    gids = torch.cat([g[v] for _, v, g in state])
    owner = torch.cat([torch.full((int(v.sum()),), s)
                       for s, (_, v, _) in enumerate(state)])
    return owner[torch.argsort(gids)]


def test_particle_count_preserved():
    """Halo exchange and migration never lose or duplicate a particle."""
    cfg, sim = port_sharded(4000)
    state, measure, metrics = sim.run(num_steps=10)
    assert sum(int(v.sum()) for _, v, _ in state) == cfg.num_molecules
    gids, _ = live(state)
    assert torch.equal(gids, torch.arange(cfg.num_molecules,
                                          dtype=torch.int32))
    total = sim.finalize_measure(measure)
    assert int(total.overflow_count) == 0
    assert int(total.halo_trunc_count) == 0
    assert int(total.collision_count) == int(metrics.collisions.sum())


def test_specular_pore_conserves_energy_sharded():
    """A closed specular system: walls, pair collisions, halo and
    migration all keep the total kinetic energy."""
    cfg, sim = port_sharded(3000, energized=False)
    state, measure, gens = sim.init()
    e0 = sum(float((st.vel[v] ** 2).sum()) for st, v, _ in state)
    for st, v, _ in state:     # invalid lanes: far away and at rest
        assert (st.pos[~v] == tshard.SENTINEL).all()
        assert not st.vel[~v].any()
    state, measure, _ = sim.run(num_steps=10, state=state, measure=measure,
                                generators=gens)
    e1 = sum(float((st.vel[v] ** 2).sum()) for st, v, _ in state)
    assert e1 == pytest.approx(e0, rel=1e-9)
    for st, v, _ in state:
        assert (st.pos[~v] == tshard.SENTINEL).all()
        assert not st.vel[~v].any()


def test_momentum_ledger_finite_and_repeatable():
    """The ledger is finite and one number a step for all slabs; a second
    run from the same seed repeats it, and the state, to the bit; epochs,
    ``start_step`` and the callback see every step once."""
    cfg, sim = port_sharded(4000)
    seen = []
    state, measure, metrics = sim.run(
        num_steps=10, epoch_callback=lambda m: seen.append(len(m.collisions)))
    assert seen == [5, 5]
    assert metrics.momentum_z.shape == (10,)
    assert torch.isfinite(metrics.momentum_z).all()
    assert int(metrics.wall_hits.sum()) > 0

    first, m1, gens = sim.init()
    first, m1, met_a = sim.run(4, state=first, measure=m1, generators=gens)
    first, m1, met_b = sim.run(6, state=first, measure=m1, generators=gens,
                               start_step=4)
    for f in LEDGER + EXACT_METRICS:
        assert torch.equal(torch.cat([getattr(met_a, f), getattr(met_b, f)]),
                           getattr(metrics, f)), f
    for (a, va, ga), (b, vb, gb) in zip(first, state):
        assert torch.equal(va, vb) and torch.equal(ga, gb)
        for f in STATE_FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert sim.run(num_steps=0)[2] is None


def test_sharded_capacity_overflow_counters_fire():
    """With the halo and migration buffers starved, every dropped lane is
    counted (halo_trunc_count, overflow_count), never lost silently."""
    cfg, sim = port_sharded(4000)
    sim.plan = dataclasses.replace(sim.plan, halo_capacity=2,
                                   migration_capacity=1)
    # ~0.2 crossings a step and face: 40 steps make two in one step (the
    # overflow of a capacity of 1) near-certain.
    state, measure, _ = sim.run(num_steps=40)
    assert measure[0].pending_vals.shape[0] == sim.plan.shard_capacity + 4
    total = sim.finalize_measure(measure)
    alive = sum(int(v.sum()) for _, v, _ in state)
    assert int(total.halo_trunc_count) > 0
    assert int(total.overflow_count) > 0
    assert alive + int(total.overflow_count) >= cfg.num_molecules
    assert alive < cfg.num_molecules
    gids, _ = live(state)
    assert len(torch.unique(gids)) == alive   # none duplicated


def test_merge_drops_what_finds_no_free_lane():
    """A slab whose buffer is full drops the migrants it cannot place and
    counts them in overflow_count: the merge's target is masked, not an
    index out of range.  Five particles are sent down into the fullest
    slab, whose capacity is cut to what it holds.  (The same engine with
    room loses nothing: test_particle_count_preserved.)"""
    cfg, sim = port_sharded(4000, scaled=True)
    counts = [int(v.sum()) for _, v, _ in sim.init()[0]]
    assert counts[0] == max(counts)
    sim.plan = dataclasses.replace(sim.plan, shard_capacity=max(counts))
    state, measure, gens = sim.init()
    cr = cfg.physics.collision_range
    st, valid, gid = state[1]
    pos, vel = st.pos.clone(), st.vel.clone()
    for k in range(5):      # just above the face, heading down
        pos[k] = torch.tensor([3 * k * cr, 0.0,
                               sim.plan.slab_z[1] + 0.05 * cr])
        vel[k] = torch.tensor([0.0, 0.0, -400.0])
    state[1] = (dataclasses.replace(st, pos=pos, vel=vel), valid, gid)
    state, measure, _ = sim.run(num_steps=1, state=state, measure=measure,
                                generators=gens)
    total = sim.finalize_measure(measure)
    alive = sum(int(v.sum()) for _, v, _ in state)
    lost = int(total.overflow_count)
    assert 0 < lost <= 5 and int(total.halo_trunc_count) == 0
    assert alive + lost == cfg.num_molecules
    assert int(state[0][1].sum()) == max(counts)     # still full
    gids, _ = live(state)
    assert len(torch.unique(gids)) == alive


def test_sharded_rejects_what_it_does_not_run():
    """hist_flush_interval is a single-card knob (the sharded step always
    runs the exact dense flush); the slabs are cut on the cell grid, so the
    all-pairs broad phase (the cube's default on one card) is refused.
    Both narrow phases of the pores and the cube on cells run
    (test_torch_sharded_pairs.py, test_torch_sharded_cube.py)."""
    with pytest.raises(ValueError, match="hist_flush_interval"):
        port_sharded(1000, n_shards=2, hist_flush_interval=8)
    with pytest.raises(NotImplementedError, match="cell grid"):
        amt.ShardedSimulation(amt.make_workload(amt.CubeConfig()),
                              n_shards=2, devices=["cpu"])
    _, pairs = port_sharded(1000, narrowphase="pairs", rebuild_interval=4)
    assert pairs.pcfg.rebuild_interval == 4
    amt.ShardedSimulation(
        amt.make_workload(amt.CubeConfig(engine=amt.EngineConfig(
            broadphase="cells"))), n_shards=2, devices=["cpu"])


def test_init_refuses_a_slab_over_capacity():
    cfg, sim = port_sharded(4000)
    sim.plan = dataclasses.replace(sim.plan, shard_capacity=64)
    with pytest.raises(ValueError, match="capacity 64"):
        sim.init()


def test_make_devices():
    """Slabs are dealt round-robin over the named devices; without names
    it takes the visible CUDA devices and raises where there is none."""
    devs = amt.make_devices(4, ["cpu"])
    assert devs == [torch.device("cpu")] * 4
    assert amt.make_devices(None, ["cpu", "meta"]) == [
        torch.device("cpu"), torch.device("meta")]
    assert amt.make_devices(5, ["cpu", "meta"])[4] == torch.device("cpu")
    with pytest.raises(ValueError):
        amt.make_devices(0, ["cpu"])
    with pytest.raises(ValueError):
        amt.make_devices(2, [])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            amt.make_devices(4)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            amt.ShardedSimulation(amt.make_workload(port_config(1000)))


@pytest.mark.parametrize("energized", [False, True],
                         ids=["specular", "energized"])
def test_one_slab_equals_single_card_engine_bitwise(energized):
    """One slab has no ghosts and no migration: what is left is the
    parking of the free lanes and the combined-lane plumbing, and it must
    not move a bit against ``Simulation`` from the same state and
    uniforms."""
    cfg = port_config(3000, energized)
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
    for f in STATE_FIELDS:
        assert torch.equal(getattr(st, f)[:n], getattr(s1, f)), f
    total = sharded.finalize_measure(ms)
    for f in ("hist", "path_sum", "path_count", "collision_count",
              "err_count", "overflow_count"):
        assert torch.equal(getattr(total, f), getattr(m1, f)), f
    for f in EXACT_METRICS + LEDGER:
        assert torch.equal(getattr(metk, f), getattr(met1, f)), f
    assert int(m1.collision_count) > int(met1.wall_hits.sum()) > 0
    # A parked lane accrues no path, takes no case and no recapture.
    assert not st.paths[n:].any() and not st.has_collided[n:].any()
    assert (st.pos[n:] == tshard.SENTINEL).all()
