"""The copied yardstick reproduces chip_smoke.py's arithmetic on the same
inputs, so no later change to the program moves it."""

import re

import torch

import chip_smoke
from counts import cells, k1, k8, k11, roofline

import argon_monte_carlo_tpu_torch as amt
from argon_monte_carlo_tpu_torch.ops import collide
from argon_monte_carlo_tpu_torch.ops import pairs as pairs_ops


def test_tensor_bytes_and_bound_are_chip_smokes():
    a = torch.zeros(1000, 3)
    b = torch.zeros(77, dtype=torch.int32)
    items = (a, (b, a[:, 0]), [b])
    assert roofline.tensor_bytes(*items) == chip_smoke.tensor_bytes(*items)
    for nbytes, ops in ((74_024_594, 60 * 999_999), (1e6, 9e12)):
        want = chip_smoke.result(0.0, 1.0, 1.0, nbytes, ops)
        ms, by = roofline.bound(nbytes, ops)
        assert (ms, by) == (want["bound_ms"], want["bound_by"])
    assert roofline.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S
    assert roofline.FP32_OPS_PER_S == chip_smoke.FP32_OPS_PER_S
    assert roofline.PAIR_TEST_OPS == chip_smoke.PAIR_TEST_OPS


def _pore_case(n=6000):
    cfg = amt.temperature_pore_config(engine=amt.EngineConfig(
        narrowphase="pairs", rebuild_interval=8)).scaled_to(n)
    sim = amt.Simulation(amt.make_workload(cfg), device="cpu")
    state, _, _ = sim.init(5)
    return cfg, sim, state


def test_cell_tests_are_chip_smokes():
    _, _, state = _pore_case()
    r = 3.4e-10 * 40
    assert cells.grid_tests(state.pos, k11.cell_side(r)) == \
        chip_smoke.allpairs_cell_tests(state.pos, r)
    cube = amt.init.init_cube(amt.CubeConfig(num_particles_override=3000),
                              torch.Generator().manual_seed(3))
    r = amt.CubeConfig().physics.collision_range
    assert cells.grid_tests(cube.pos, k11.cell_side(r)) == \
        chip_smoke.allpairs_cell_tests(cube.pos, r)


def test_neighbor_slots_are_chip_smokes_and_k1_counts_what_it_finds():
    cfg, sim, state = _pore_case()
    grid, pcfg = sim.grid, sim.pcfg
    _, table, pslot, _ = collide.bin_and_table(state.pos, grid)
    for cols in (slice(0, 27), slice(13, 27)):
        assert cells.neighbor_slots(table, pslot, grid, state.num_particles,
                                    cols) == chip_smoke.neighbor_slots(
            table, pslot, grid, state.num_particles, cols)
    cr, k = cfg.physics.collision_range, pcfg.rebuild_interval
    reach, clipped = pairs_ops.reach_radii(state.vel, cr, cfg.dt, k,
                                           0.5 * grid.cell_size)
    assert not clipped.any()
    assert torch.allclose(k1.reach_radii(state.vel, cr, cfg.dt, k), reach,
                          rtol=1e-6, atol=0.0)
    got = collide.rebuild_sweep(state.pos, reach, table, pslot, grid,
                                pcfg.top_k)
    # With rows wide enough that none is full, and every particle swept,
    # the program's own half-shell sweep lists each pair within reach
    # once: the count's.
    cands, unswept = collide.rebuild_sweep(state.pos, reach, table, pslot,
                                           grid, 64)[:2]
    assert not unswept.any()
    assert int((cands >= 0).sum(dim=1).max()) < 64
    pairs = cells.pairs_within(state.pos, reach)
    assert pairs == int((cands >= 0).sum()) > 0
    # chip_smoke.check_rebuild_sweep's count of the same call: its padded
    # table, slot planes and top_k rows are more than the work.
    padded = chip_smoke.tensor_bytes(state.pos, reach, table, pslot,
                                     grid.neighbors, grid.active_rank, got)
    assert k1.bytes_moved(state.num_particles, pairs) < padded
    ms, by = k1.bound_ms(state.pos, state.vel, cr, cfg.dt, k)
    assert (ms, by) == roofline.bound(k1.bytes_moved(state.num_particles,
                                                     pairs))


def test_k8_in_place_bytes_are_chip_smokes():
    src = open(chip_smoke.__file__).read()
    assert re.search(r"in_place = n \* \(41 \+ 28 \+ 5\) \+ 30 \* hits "
                     r"\+ 8 \* energized // steps", src)
    assert k8.PER_PARTICLE == 41 + 28 + 5 and k8.PER_HIT == 30 \
        and k8.PER_ENERGIZED == 8
    # PERF.md's 74,024,594 bytes at 999,999 particles: 73,999,926 for the
    # particles, the rest for a step's wall-case lanes.
    assert k8.bytes_in_place(999_999, 0, 0) == 73_999_926
