"""The cube (Open_Air_Cube_MC) in the port against the JAX package: host
constants, the all-pairs search's plain version (K11's twin), ``init_cube``
and the cube engine step by step, plus the reference's own invariants and
its mean-free-path check.

Tolerances: host constants, partners, counts, histograms and staging
masks exact; state within 1e-12 relative (float64); kinetic energy
conserved to 1e-12 relative (float64), as in the reference's tests.
"""

import ctypes
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import argon_monte_carlo_tpu as amc
import argon_monte_carlo_tpu_torch as amt
from argon_monte_carlo_tpu.config import EngineConfig as JEngine
from argon_monte_carlo_tpu.geometry import CubeGeometry as JCube
from argon_monte_carlo_tpu.ops import collide as jcollide
from argon_monte_carlo_tpu_torch import convert, kernels
from argon_monte_carlo_tpu_torch.init import init_cube, init_pore
from argon_monte_carlo_tpu_torch.ops import collide as tcollide

CR = amt.physics.CUBE_PHYSICS.collision_range
SIDE = 50e-9  # ~3,100 particles at the published density


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The engine runs thousands of small tensor ops a test.  Spread over
    intra-op threads on a CPU that parallel test workers share, they stall
    on each other (this file took 364 s of a tier-1 run, 12 s alone); one
    thread a worker keeps it near its time alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("override", [None, 3000])
def test_cube_config_equal(override):
    j = amc.CubeConfig(num_particles_override=override)
    t = amt.CubeConfig(num_particles_override=override)
    assert t.num_molecules == j.num_molecules
    assert override is not None or t.num_molecules == 24_627
    assert (t.num_timesteps, t.dt, t.seed) == (j.num_timesteps, j.dt, j.seed)
    assert t.num_timesteps == 500
    assert dataclasses.asdict(t.physics) == dataclasses.asdict(j.physics)
    assert (t.geometry.volume, t.geometry.bounds) == (j.geometry.volume,
                                                      j.geometry.bounds)
    assert t.engine.broadphase == j.engine.broadphase == "allpairs"
    assert (t.stratified_init, t.init_cells_per_axis) == (
        j.stratified_init, j.init_cells_per_axis)


def random_gas(n, side, seed):
    return np.random.default_rng(seed).uniform(0.0, side, (n, 3))


@pytest.mark.parametrize("case", ["reference", "ragged_tiles", "dense"])
def test_allpairs_plain_matches_reference(case):
    """K11's plain version equals collide.allpairs_partner_search exactly:
    the reference test's four particles (test_collide.py:88-99); N not a
    multiple of the tile with hits across tile boundaries and particles
    with no partner; a dense gas where most particles have one."""
    if case == "reference":
        pos = np.array([[0.0, 0.0, 0.0], [0.5 * CR, 0.0, 0.0],
                        [1e-8, 1e-8, 1e-8], [5e-9, 0.0, 0.0]])
        radius, tile = CR, 4
    else:
        pos = random_gas(1000, 20e-9, 7)
        radius, tile = (1.0e-9, 64) if case == "ragged_tiles" else (2e-9, 128)
    want, overflow = jcollide.allpairs_partner_search(jnp.asarray(pos),
                                                      radius, tile)
    got = tcollide.allpairs_partner_search(torch.from_numpy(pos), radius,
                                           tile)
    assert got.dtype == torch.int32 and int(overflow) == 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    p = got.numpy()
    if case == "reference":
        assert p.tolist() == [1, 0, -1, -1]
    else:
        idx = np.arange(len(p))
        assert ((p >= 0) & (p // tile != idx // tile)).any()
        assert (p == -1).any() and (p >= 0).any()


def test_allpairs_float32_matches_reference():
    pos = random_gas(700, 15e-9, 3).astype(np.float32)
    want, _ = jcollide.allpairs_partner_search(jnp.asarray(pos), 1e-9, 256)
    got = tcollide.allpairs_partner_search(torch.from_numpy(pos), 1e-9, 256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


EDGE_R = 1e-9


def edge_gas(case):
    """float32 positions where a z-window search could go wrong: pairs
    whose z gap is the radius and one ulp either side of it (x and y
    equal, so d^2 is dz^2 alone), at several z; every particle in one z
    band; z below 0 and above a 100 nm box; N of 1, 2 and 3."""
    f32 = np.float32
    rng = np.random.default_rng(len(case))
    if case == "gap at r":
        rows = []
        for k, z0 in enumerate((3e-9, 7.1e-9, -2.5e-9, 1.3e-7, 0.0, 4e-8)):
            z0 = f32(z0)
            at_r = f32(z0 + f32(EDGE_R))
            for step, zj in enumerate((np.nextafter(at_r, f32(-np.inf)),
                                       at_r,
                                       np.nextafter(at_r, f32(np.inf)))):
                x = f32(5e-9 * (3 * k + step + 1))
                rows += [(x, 0.0, z0), (x, 0.0, zj)]
        return np.array(rows, f32)
    if case == "one band":
        n = 600
        z = 4e-9 + rng.uniform(0.0, EDGE_R / 4, n)
        return np.stack([rng.uniform(0, 20e-9, n), rng.uniform(0, 20e-9, n),
                         z], axis=1).astype(f32)
    if case == "outside the box":
        n = 800
        z = np.where(rng.uniform(size=n) < 0.5,
                     rng.uniform(-30e-9, -10e-9, n),
                     rng.uniform(110e-9, 130e-9, n))
        return np.stack([rng.uniform(0, 6e-9, n), rng.uniform(0, 6e-9, n),
                         z], axis=1).astype(f32)
    n = int(case[-1])
    pos = np.array([[1e-9, 1e-9, 1e-9], [1.5e-9, 1e-9, 1.2e-9],
                    [9e-9, 9e-9, 9e-9]], f32)
    return pos[:n]


@pytest.mark.parametrize("tile", [64, 256])
@pytest.mark.parametrize("case", ["gap at r", "one band", "outside the box",
                                  "N=1", "N=2", "N=3"])
def test_allpairs_plain_matches_reference_at_the_window_edges(case, tile):
    """K11's plain version (a z-window search) equals the reference's
    all-pairs scan exactly, float32, where its window could lose a hit:
    pairs exactly at the radius in z and one ulp either side, all
    particles in one band, z outside the box, and one to three
    particles."""
    pos = edge_gas(case)
    want, _ = jcollide.allpairs_partner_search(jnp.asarray(pos), EDGE_R,
                                               tile)
    got = tcollide.allpairs_partner_search(torch.from_numpy(pos), EDGE_R,
                                           tile)
    assert got.dtype == torch.int32 and got.shape == (pos.shape[0],)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    p = got.numpy()
    if case == "gap at r":
        # Of each triple of probe pairs, the one below r hits, the one
        # above does not.
        hit = (p[0::2] >= 0).reshape(-1, 3)
        assert hit[:, 0].all() and not hit[:, 2].any()
    elif case in ("one band", "outside the box"):
        assert (p >= 0).any() and (p == -1).any()
    else:
        assert p.tolist() == [[-1], [1, 0], [1, 0, -1]][pos.shape[0] - 1]


@pytest.mark.parametrize("n,slabs", [(0, 3), (1, 3), (48, 3), (49, 4),
                                     (24_627, 1_540)])
def test_allpairs_slabs(n, slabs):
    """K11 counts N particles into one z-slab a 16 of them, at least
    three, whatever the box (the key wraps modulo the count)."""
    assert tcollide.allpairs_slabs(n) == slabs


@pytest.mark.parametrize("stratified", [False, True])
def test_init_cube(stratified):
    """Both fills lie in the box; the stratified one puts exactly
    floor(N / c^3) particles in each init cell, in order, then a uniform
    remainder (test_rng.py:94-110).  The draws land on the generator's
    device."""
    c = 5
    cfg = amt.CubeConfig(num_particles_override=c**3 * 11 + 7,
                         stratified_init=stratified, init_cells_per_axis=c,
                         engine=amt.EngineConfig(broadphase="allpairs",
                                                 dtype="float64"))
    gen = torch.Generator()
    gen.manual_seed(3)
    state = init_cube(cfg, gen)
    pos = state.pos.numpy()
    n = cfg.num_molecules
    assert pos.shape == (n, 3) and state.pos.device.type == "cpu"
    assert state.vel.shape == (n, 3) and state.pos.dtype == torch.float64
    side = cfg.geometry.lx
    assert pos.min() >= 0.0 and pos.max() <= side
    assert abs(pos.mean() - side / 2) < 0.05 * side
    if stratified:
        q = n // c**3
        cells = np.floor(pos[: c**3 * q] / (side / c)).astype(int)
        flat = cells[:, 0] * c * c + cells[:, 1] * c + cells[:, 2]
        np.testing.assert_array_equal(flat, np.repeat(np.arange(c**3), q))


def test_init_pore_draws_on_the_generator_device():
    cfg = amt.temperature_pore_config().scaled_to(2000)
    gen = torch.Generator()
    gen.manual_seed(1)
    state = init_pore(cfg, gen)
    assert state.pos.device == gen.device
    assert state.num_particles == cfg.num_molecules


def cube_pair(steps_per_epoch=5, **kwargs):
    geom = dict(lx=SIDE, ly=SIDE, lz=SIDE)
    jc = amc.CubeConfig(geometry=JCube(**geom), engine=JEngine(
        broadphase="allpairs", dtype="float64",
        steps_per_epoch=steps_per_epoch), **kwargs)
    tc = amt.CubeConfig(geometry=amt.CubeGeometry(**geom),
                        engine=amt.EngineConfig(
                            broadphase="allpairs", dtype="float64",
                            steps_per_epoch=steps_per_epoch), **kwargs)
    return jc, tc


COUNTERS = ("path_count", "collision_count", "err_count", "overflow_count",
            "hist_drop_count", "hot_spill_count")


def to_port(jstate, jmeas):
    arrays = {f: np.asarray(getattr(jstate, f))
              for f in ("pos", "vel", "paths", "has_collided")}
    arrays.update({f: np.asarray(getattr(jmeas, f)) for f in (
        "hist", "path_sum", "pending_vals", "pending_mask") + COUNTERS})
    return convert.state_from_numpy(arrays, "cpu", torch.float64)


def test_cube_engine_matches_reference_step_by_step():
    """The port's cube engine against the JAX cube engine, float64, from
    the reference's initial state, 20 steps one at a time.  The port runs
    on its own from that state (every count, the histogram and the
    staging exact each step) and also takes each step from the reference's
    state before it (the state after the step within 1e-12).  Hard-sphere
    collisions amplify a last-bit difference by ~2x a step, so the
    free-running states drift past 1e-12 of each other by step ~17; the
    re-synced step holds the tolerance at every step."""
    jc, tc = cube_pair()
    jsim = amc.Simulation(amc.make_workload(jc))
    tsim = amt.Simulation(amt.make_workload(tc), device="cpu")
    assert tsim.grid is None and tsim.host_grid is None
    jstate, jmeas, run_key = jsim.init()
    n = jstate.num_particles
    tstate, tmeas = to_port(jstate, jmeas)
    zeros = torch.zeros((n, 2), dtype=torch.float64)
    pairs = 0
    for i in range(20):
        synced = to_port(jstate, jmeas)
        jstate, jmeas, jmet = jsim.run(num_steps=1, state=jstate,
                                       measure=jmeas, run_key=run_key,
                                       start_step=i)
        tstate, tmeas, tmet = tsim.run(num_steps=1, state=tstate,
                                       measure=tmeas, start_step=i,
                                       draw=lambda _: zeros)
        sstate, smeas, _ = tsim.run(num_steps=1, state=synced[0],
                                    measure=synced[1], start_step=i,
                                    draw=lambda _: zeros)
        for f in ("collisions", "wall_hits", "oob_after_walls",
                  "oob_after_pairs"):
            assert int(getattr(tmet, f)[0]) == int(
                np.asarray(getattr(jmet, f))[0]), (i, f)
        for state, meas in ((tstate, tmeas), (sstate, smeas)):
            for f in COUNTERS:
                assert int(getattr(meas, f)) == int(getattr(jmeas, f)), (i, f)
            np.testing.assert_array_equal(meas.hist.numpy(),
                                          np.asarray(jmeas.hist))
            np.testing.assert_array_equal(state.has_collided.numpy(),
                                          np.asarray(jstate.has_collided))
            np.testing.assert_array_equal(meas.pending_mask.numpy(),
                                          np.asarray(jmeas.pending_mask))
        np.testing.assert_allclose(smeas.path_sum.numpy(),
                                   np.asarray(jmeas.path_sum), rtol=1e-12)
        for f in ("pos", "vel", "paths"):
            want = np.asarray(getattr(jstate, f))
            np.testing.assert_allclose(getattr(sstate, f).numpy(), want,
                                       rtol=1e-12,
                                       atol=1e-12 * np.abs(want).max())
        pairs += int(tmet.collisions[0])
    assert pairs > 20 and int(tmeas.path_count) > 0


def test_cube_invariants():
    """test_engine.py:21-42 on the port's own Generator: every particle in
    the box, kinetic energy conserved to 1e-12, no solver errors, and a
    repeatable run per seed."""
    cfg = amt.CubeConfig(num_particles_override=3000, engine=amt.EngineConfig(
        broadphase="allpairs", dtype="float64", steps_per_epoch=25))
    sim = amt.Simulation(amt.make_workload(cfg), device="cpu")
    state0, measure, gen = sim.init()
    e0 = float((state0.vel**2).sum())
    state, measure, metrics = sim.run(num_steps=50, state=state0,
                                      measure=measure, generator=gen)
    g = cfg.geometry
    pos = state.pos.numpy()
    for axis, hi in enumerate((g.lx, g.ly, g.lz)):
        assert (pos[:, axis] >= 0).all() and (pos[:, axis] <= hi).all()
    assert float((state.vel**2).sum()) == pytest.approx(e0, rel=1e-12)
    assert int(measure.err_count) == 0
    assert int(metrics.collisions.sum()) > 0
    assert int(metrics.wall_hits.sum()) == 0
    again, _, _ = sim.run(num_steps=50)
    assert torch.equal(again.pos, state.pos)


def test_measured_mfp_matches_analytic():
    """test_mfp_validation.py:29-68 on the port, float64 on the CPU: sigma
    x4 in a 40 nm box at ambient density, ~0.2 nm of drift a step, 20
    mean-free times; the measured mean free path within 20% of lambda and
    the free paths exponential."""
    physics = amt.GasPhysics(sigma=3.6e-19 * 4.0)
    lam = physics.lambda_mfp
    geom = amt.CubeGeometry(lx=40e-9, ly=40e-9, lz=40e-9)
    n = physics.num_molecules(geom.volume)
    assert 1200 < n < 2000
    steps_per_mft = max(1, int(round(physics.tau
                                     / (0.2e-9 / physics.v_mean))))
    cfg = amt.CubeConfig(
        geometry=geom, physics=physics, nmft=20, steps_per_mft=steps_per_mft,
        engine=amt.EngineConfig(broadphase="allpairs", dtype="float64",
                                steps_per_epoch=200, allpairs_tile=512))
    sim = amt.Simulation(amt.make_workload(cfg), device="cpu")
    _, measure, _ = sim.run()
    count = int(measure.path_count)
    assert count > 3000, count
    measured = float(measure.path_sum[0]) / count
    assert measured == pytest.approx(lam, rel=0.20), (measured, lam)
    hist = measure.hist[0][:200].numpy()
    x = (np.arange(200) + 0.5) * (1e-6 / 200)
    m = hist > 5
    assert m.sum() > 4
    coef = np.polyfit(x[m], np.log(hist[m]), 1)
    assert -1.0 / coef[0] == pytest.approx(lam, rel=0.35)


def test_allpairs_wrapper_passes_declared_arguments(monkeypatch):
    """K11's wrapper, forced down its kernel side with the launch
    intercepted, passes the declared argument kinds (the stream is
    launch's), r^2 as a float and the slab count of N; its scratch is
    kept between calls of one size and grown for a larger N; float64 is
    refused."""
    calls = []

    def fake_launch(name, device, *args):
        sig = kernels._SIGNATURES[name][:-1]
        assert len(args) == len(sig)
        for arg, kind in zip(args, sig):
            want = {ctypes.c_void_p: ctypes.c_void_p, ctypes.c_int: int,
                    ctypes.c_float: float}[kind]
            assert isinstance(arg, want), (arg, kind)
        calls.append((name, args[1], args[2], args[3],
                      [a.value for a in args[4:7]]))
        # The look-back words handed over with their count, which the
        # kernel checks against what its scan needs.
        scan_words = tcollide.compact.lookback_scratch(device, 1).shape[0]
        assert args[8] == scan_words >= 1 + -(-args[3] //
                                              tcollide.COUNT_SCAN_TILE)

    monkeypatch.setattr(kernels, "use_plain", lambda t: False)
    monkeypatch.setattr(kernels, "launch", fake_launch)
    for n in (10, 10, 5000):
        out = tcollide.allpairs_partner_search(torch.zeros((n, 3)), 2.0, 4)
        assert out.shape == (n,) and out.dtype == torch.int32
    first, again, larger = calls
    assert first[:4] == ("allpairs_partner", 10, 4.0, 3)
    assert again == first
    assert larger[:4] == ("allpairs_partner", 5000, 4.0, 313)
    assert larger[4][2] != first[4][2]  # the copy grew: 5000 rows
    with pytest.raises(TypeError):
        tcollide.allpairs_partner_search(torch.zeros((10, 3)).double(), 2.0,
                                         4)


# --------------------------------------------------------------------------
# The cube on the cell grid: a grid centred on the box
# --------------------------------------------------------------------------


def cube_grids(dtype="float64", capacity=24):
    """The published cube's grid on both sides: host grids and device
    grids centred on the box."""
    geom_j, geom_t = JCube(), amt.CubeGeometry()
    cell = 2.0 * CR
    jg = jcollide.grid_for_cube(geom_j, cell, capacity)
    tg = tcollide.grid_for_cube(geom_t, cell, capacity)
    center = (geom_t.lx / 2.0, geom_t.ly / 2.0)
    jdg = jcollide.DeviceGrid.from_grid(jg, getattr(jnp, dtype), center)
    tdg = tcollide.DeviceGrid.from_grid(tg, getattr(torch, dtype), "cpu",
                                        center)
    return jg, tg, jdg, tdg


def test_grid_for_cube_equals_reference():
    jg, tg, jdg, tdg = cube_grids()
    for f in ("cell_size", "z_lo", "nz", "num_cells", "capacity"):
        assert getattr(jg, f) == getattr(tg, f), f
    for f in ("nx", "layer_base", "half_extent", "neighbors"):
        a, b = getattr(jg, f), getattr(tg, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert jg.active_cells is None and tg.active_cells is None
    assert (tdg.center_x, tdg.center_y) == (jdg.center_x, jdg.center_y)
    assert tdg.center_x == amt.CubeGeometry().lx / 2.0
    # The engine builds this grid for the cube on cells.
    cfg = amt.CubeConfig(engine=amt.EngineConfig(broadphase="cells"))
    host, dev = amt.engine.build_grids(amt.make_workload(cfg), "cpu")
    assert (dev.center_x, dev.center_y) == (tdg.center_x, tdg.center_y)
    assert host.half_extent[0] * 2 >= cfg.geometry.lx


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k2_twin_with_the_centre_matches_reference(dtype):
    """K2's twin bins like the reference's assign_cells on the centred
    grid, exactly: particles anywhere in the box, strays outside it, and
    particles on every cell edge in x and y and one ulp either side."""
    np_dtype = getattr(np, dtype)
    jg, tg, jdg, tdg = cube_grids(dtype)
    geom = amt.CubeGeometry()
    rng = np.random.default_rng(5)
    n = 6000
    pos = rng.uniform(-0.02, 1.02, (n, 3)) * np.array(
        [geom.lx, geom.ly, geom.lz])
    edges = (np.arange(int(tg.nx[0]) + 1) * tg.cell_size
             - tg.half_extent[0] + geom.lx / 2.0).astype(np_dtype)
    k = rng.integers(0, len(edges), (n // 2, 2))
    on = edges[k]
    step = rng.integers(-1, 2, on.shape)
    on = np.where(step < 0, np.nextafter(on, np_dtype(-np.inf)), on)
    on = np.where(step > 0, np.nextafter(on, np_dtype(np.inf)), on)
    pos[: n // 2, :2] = on
    pos = pos.astype(np_dtype)
    want = np.asarray(jcollide.assign_cells(jnp.asarray(pos), jdg))
    got = tcollide.assign_cells_plain(torch.from_numpy(pos), tdg)
    np.testing.assert_array_equal(got.numpy(), want)
    cell_id, _, _, overflow = tcollide.bin_and_table_plain(
        torch.from_numpy(pos), tdg)
    np.testing.assert_array_equal(cell_id.numpy(), want)
    # Without the centre the box would sit in one corner of the grid.
    uncentred = dataclasses.replace(tdg, center_x=0.0, center_y=0.0)
    assert not torch.equal(
        tcollide.assign_cells_plain(torch.from_numpy(pos), uncentred), got)


def test_cube_cells_matches_allpairs():
    """tests/test_engine.py:45-66 on the port: the cube on the cell grid
    with the per-step sweep against its all-pairs search, 40 steps from
    one seed: positions bitwise equal, the counts equal, no overflow."""
    common = dict(num_particles_override=4000)
    cfg_a = amt.CubeConfig(engine=amt.EngineConfig(
        broadphase="allpairs", dtype="float64", steps_per_epoch=20),
        **common)
    cfg_c = amt.CubeConfig(engine=amt.EngineConfig(
        broadphase="cells", dtype="float64", steps_per_epoch=20,
        cell_occupancy=6.0, cell_capacity=24), **common)
    st_a, m_a, met_a = amt.Simulation(amt.make_workload(cfg_a),
                                      device="cpu").run(num_steps=40)
    st_c, m_c, met_c = amt.Simulation(amt.make_workload(cfg_c),
                                      device="cpu").run(num_steps=40)
    assert torch.equal(st_a.pos, st_c.pos)
    assert torch.equal(st_a.vel, st_c.vel)
    assert torch.equal(met_a.collisions, met_c.collisions)
    for f in ("collision_count", "path_count"):
        assert int(getattr(m_a, f)) == int(getattr(m_c, f)), f
    assert torch.equal(m_a.hist, m_c.hist)
    assert int(m_c.collision_count) > 0
    assert int(m_c.overflow_count) == 0
