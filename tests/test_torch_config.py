"""Port vs reference: host constants, config helpers (the pairs engine's
capacities included) and the host grid.

Every number here is host-side Python/numpy in both packages, so the
comparison is exact equality.
"""

import dataclasses

import numpy as np
import pytest

import argon_monte_carlo_tpu as amc
import argon_monte_carlo_tpu_torch as amt
from argon_monte_carlo_tpu import config as jcfg
from argon_monte_carlo_tpu import engine as jengine
from argon_monte_carlo_tpu import physics as jphys
from argon_monte_carlo_tpu.ops import collide as jcollide
from argon_monte_carlo_tpu.utils import debye as jdebye
from argon_monte_carlo_tpu_torch import config as tcfg
from argon_monte_carlo_tpu_torch import engine as tengine
from argon_monte_carlo_tpu_torch import physics as tphys
from argon_monte_carlo_tpu_torch.ops import collide as tcollide
from argon_monte_carlo_tpu_torch.utils import debye as tdebye

PHYSICS_PROPS = ["argon_radius", "collision_radius", "collision_range",
                 "lambda_mfp", "v_mean", "a_shape", "tau"]
GEOMETRY_PROPS = ["gap_radius", "open_air_radius", "gap_height",
                  "cold_coating_height", "total_height", "gap_bottom",
                  "gap_top", "cold_top", "hot_volume", "gap_volume",
                  "cold_volume", "open_air_volume", "volume", "bounds"]


@pytest.mark.parametrize("name", ["CUBE_PHYSICS", "PORE_PHYSICS",
                                  "TEMPERATURE_PORE_PHYSICS"])
def test_physics_constants_equal(name):
    j, t = getattr(jphys, name), getattr(tphys, name)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    for prop in PHYSICS_PROPS:
        assert getattr(j, prop) == getattr(t, prop), prop
    assert j.num_molecules(1e-21) == t.num_molecules(1e-21)
    assert j.kinetic_energy(431.5) == t.kinetic_energy(431.5)


@pytest.mark.parametrize("target", [None, 4000, 1_000_000])
def test_pore_config_and_geometry_equal(target):
    jc = amc.temperature_pore_config()
    tc = amt.temperature_pore_config()
    if target is not None:
        jc, tc = jc.scaled_to(target), tc.scaled_to(target)
    for prop in GEOMETRY_PROPS:
        assert getattr(jc.geometry, prop) == getattr(tc.geometry, prop), prop
    phys = jc.physics
    for fn in ("open_air_collision_radius", "gap_collision_radius",
               "pore_collision_radius"):
        assert (getattr(jc.geometry, fn)(phys)
                == getattr(tc.geometry, fn)(tc.physics))
    n = jc.num_molecules
    assert n == tc.num_molecules
    assert (jc.geometry.segment_particle_counts(n)
            == tc.geometry.segment_particle_counts(n))
    for prop in ("dt", "num_timesteps", "surface_energy_cold",
                 "surface_energy_hot"):
        assert getattr(jc, prop) == getattr(tc, prop), prop
    jt, tt = jc.gap_energy_table(), tc.gap_energy_table()
    assert (jt.z_lo, jt.z_hi) == (tt.z_lo, tt.z_hi)
    np.testing.assert_array_equal(jt.energies, tt.energies)
    for cap in (None, 4):
        je = jcfg.EngineConfig(cell_capacity=cap)
        te = tcfg.EngineConfig(cell_capacity=cap)
        args = (n, jc.geometry.volume)
        assert (jcfg.cell_size_for(je, phys, *args)
                == tcfg.cell_size_for(te, tc.physics, *args))
        assert (jcfg.cell_capacity_for(je, phys, *args)
                == tcfg.cell_capacity_for(te, tc.physics, *args))


def test_debye_equal():
    temps = np.linspace(250.0, 400.0, 37)
    for t_debye, atoms in ((jdebye.T_DEBYE_GRAPHENE, 2),
                           (jdebye.T_DEBYE_ALUMINA, 10)):
        np.testing.assert_array_equal(
            jdebye.surface_energy(temps, t_debye, atoms, 1.38064852e-23),
            tdebye.surface_energy(temps, t_debye, atoms, 1.38064852e-23),
        )


@pytest.mark.parametrize("target,capacity", [(4000, None), (4000, 4),
                                             (1_000_000, None)])
def test_host_grid_equal(target, capacity):
    jc = amc.temperature_pore_config().scaled_to(target)
    tc = amt.temperature_pore_config().scaled_to(target)
    n, vol = jc.num_molecules, jc.geometry.volume
    size = jcfg.cell_size_for(jcfg.EngineConfig(), jc.physics, n, vol)
    cap = capacity or jcfg.cell_capacity_for(jcfg.EngineConfig(), jc.physics,
                                             n, vol)
    jg = jcollide.grid_for_pore(jc.geometry, size, cap)
    tg = tcollide.grid_for_pore(tc.geometry, size, cap)
    for f in ("cell_size", "z_lo", "nz", "num_cells", "capacity"):
        assert getattr(jg, f) == getattr(tg, f), f
    for f in ("nx", "layer_base", "half_extent", "neighbors", "active_cells"):
        a, b = getattr(jg, f), getattr(tg, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("kwargs,match", [
    (dict(narrowphase="pairs", rebuild_interval=8), "ROADMAP"),
    (dict(cube=True), "cell grid"),
])
def test_unported_options_raise(kwargs, match):
    """What the port does not run yet, all in the z-slab engine: its pairs
    mode (ROADMAP Q1-C) and the sharded cube."""
    kwargs = dict(kwargs)
    cube = kwargs.pop("cube", False)
    engine = tcfg.EngineConfig(**kwargs)
    cfg = (tcfg.CubeConfig(engine=engine) if cube
           else amt.temperature_pore_config(engine=engine).scaled_to(1000))
    with pytest.raises(NotImplementedError, match=match):
        amt.ShardedSimulation(amt.make_workload(cfg), n_shards=2,
                              devices=["cpu"])


def test_audits_and_the_cube_on_cells_construct():
    """The options that used to raise: the missed-case audit, and the cube
    on the cell grid (a grid centred on the box)."""
    assert tcfg.EngineConfig(debug_audits=True).debug_audits
    cube = tcfg.CubeConfig(engine=tcfg.EngineConfig(broadphase="cells"))
    sim = amt.Simulation(amt.make_workload(cube), device="cpu")
    geom = cube.geometry
    assert (sim.grid.center_x, sim.grid.center_y) == (geom.lx / 2.0,
                                                      geom.ly / 2.0)


def test_allpairs_options():
    """The all-pairs broad phase runs the cube (its default) and the pore's
    sweep; the pairs narrow phase refuses it, as the reference's
    make_pairs_step_fn does (engine.py:343-344)."""
    assert tcfg.CubeConfig().engine.broadphase == "allpairs"
    eng = tcfg.EngineConfig(broadphase="allpairs")
    assert eng.allpairs_tile == jcfg.EngineConfig().allpairs_tile
    amt.temperature_pore_config(engine=eng)
    with pytest.raises(ValueError, match="requires broadphase='cells'"):
        tcfg.EngineConfig(broadphase="allpairs", narrowphase="pairs",
                          rebuild_interval=8)


@pytest.mark.parametrize("kwargs", [
    dict(rebuild_interval=8),                       # the sweep re-sweeps
    dict(narrowphase="pairs", rebuild_interval=0),
    dict(narrowphase="verlet"),
    dict(broadphase="octree"),
])
def test_engine_options_checked(kwargs):
    with pytest.raises(ValueError):
        tcfg.EngineConfig(**kwargs)
    tcfg.EngineConfig(narrowphase="pairs", rebuild_interval=8)


def pairs_workloads(target, rebuild_interval=8, capacity=None):
    def engine(module):
        return module.EngineConfig(narrowphase="pairs", cell_capacity=capacity,
                                   rebuild_interval=rebuild_interval)
    return (amc.make_workload(amc.temperature_pore_config(
                engine=engine(jcfg)).scaled_to(target)),
            amt.make_workload(amt.temperature_pore_config(
                engine=engine(tcfg)).scaled_to(target)))


@pytest.mark.parametrize("target", [3000, 20_000, 1_000_000, 10_000_000])
def test_pairs_config_equal(target):
    """pairs_cell_capacity_for and pairs_config_for (the PairConfig's
    capacities) equal the reference's: host arithmetic on both sides."""
    jw, tw = pairs_workloads(target)
    phys = jw.cfg.physics
    args = (jw.cfg.num_molecules, jw.fluid_volume)
    for cap in (None, 16):
        assert (jcfg.pairs_cell_capacity_for(
                    jcfg.EngineConfig(cell_capacity=cap), phys, *args)
                == tcfg.pairs_cell_capacity_for(
                    tcfg.EngineConfig(cell_capacity=cap), tw.cfg.physics,
                    *args))
    want = dataclasses.asdict(jengine.pairs_config_for(jw))
    got = dataclasses.asdict(tengine.pairs_config_for(tw))
    assert got == {k: want[k] for k in got}
    assert not want["bf16_hit"] and not want["occupancy_skip"]


def test_pairs_config_sizes_spill_hot():
    """A thin cell capacity moves expected spills into the re-search
    budget, as the reference sizes it."""
    jw, tw = pairs_workloads(1_000_000, capacity=8)
    want = dataclasses.asdict(jengine.pairs_config_for(jw))
    got = dataclasses.asdict(tengine.pairs_config_for(tw))
    assert got == {k: want[k] for k in got}
    assert got["research_capacity"] > dataclasses.asdict(
        tengine.pairs_config_for(pairs_workloads(1_000_000)[1])
    )["research_capacity"]


def test_pairs_rejects_uncoverable_workload():
    """At K=50 the in-reach expectation outgrows any top_k emission: both
    packages refuse rather than run a pair list that misses collisions."""
    jw, tw = pairs_workloads(3000, rebuild_interval=50)
    with pytest.raises(ValueError, match="cannot cover"):
        jengine.pairs_config_for(jw)
    with pytest.raises(ValueError, match="cannot cover"):
        tengine.pairs_config_for(tw)
    with pytest.raises(ValueError, match="cannot cover"):
        amt.Simulation(tw, device="cpu")
