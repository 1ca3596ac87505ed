"""Checkpoints of the port: files both packages read, and resume bitwise
equal to the uninterrupted run.

The port draws every step from a ``torch.Generator``; its checkpoint keeps
the generator's state, so a run resumed at step k draws what the
uninterrupted run drew.  Compared bitwise after each resumed run: pos,
vel, paths, has_collided, hist, path_sum, path_count and collision_count
(and, sharded, valid and gid).  A pairs run resumed mid-window drops its
list and rebuilds at once: the list is a superset and the test exact, so
the trajectory does not move (as the reference's test_pairs.py:113-147
shows for its engine) while no one-step latency of the engine falls in
the window; with the list and window in the file the resumed run rebuilds
on the uninterrupted run's steps, which holds at any size.  Array round
trips between the packages are exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import argon_monte_carlo_tpu as amc
import argon_monte_carlo_tpu_torch as amt
from argon_monte_carlo_tpu.config import EngineConfig as JEngine
from argon_monte_carlo_tpu.io import checkpoint as jckpt
from argon_monte_carlo_tpu.parallel.mesh import make_mesh
from argon_monte_carlo_tpu.parallel.shard import (
    ShardedSimulation as JSharded)
from argon_monte_carlo_tpu_torch.io import checkpoint as tckpt

STATE = ("pos", "vel", "paths", "has_collided")
MEASURE = ("hist", "path_sum", "path_count", "collision_count")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Thousands of small tensor ops a run: one intra-op thread a test
    worker keeps them from stalling on each other (test_torch_cube.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_same_run(got, want):
    (gs, gm), (ws, wm) = got, want
    for f in STATE:
        assert torch.equal(getattr(gs, f), getattr(ws, f)), f
    for f in MEASURE:
        assert torch.equal(getattr(gm, f), getattr(wm, f)), f


def resumed(sim_factory, total, split, tmp_path, carry_window=False):
    """(uninterrupted, resumed) final (state, measure), and the resumed
    run's per-step metrics: ``split`` steps, a checkpoint, a fresh
    Simulation that loads it and runs the rest; with ``carry_window`` the
    checkpoint holds the pairs run's list and window and the fresh
    Simulation continues them."""
    sim = sim_factory()
    state, meas, gen = sim.init()
    whole = sim.run(num_steps=total, state=state, measure=meas,
                    generator=gen)
    sim = sim_factory()
    state, meas, gen = sim.init()
    state, meas, _ = sim.run(num_steps=split, state=state, measure=meas,
                             generator=gen)
    window = sim.pair_window() if carry_window else None
    path = tckpt.save_checkpoint(str(tmp_path / "ck.npz"), state, meas, gen,
                                 split, pair_window=window)
    state, meas, gen, step = tckpt.load_checkpoint(path, "cpu")
    assert step == split
    assert not tckpt.written_by_reference(path)
    sim = sim_factory()
    window = tckpt.load_pair_window(path, "cpu")
    assert (window is not None) == carry_window
    if window is not None:
        sim.resume_pair_window(state, *window)
    again = sim.run(num_steps=total - split, state=state, measure=meas,
                    generator=gen, start_step=step)
    return whole[:2], again[:2], whole[2], again[2]


def simulation(cfg):
    return lambda: amt.Simulation(amt.make_workload(cfg), device="cpu")


@pytest.mark.parametrize("case", ["sweep", "pairs mid-window",
                                  "pairs mid-window, window carried",
                                  "cube"])
def test_resume_is_bitwise(case, tmp_path):
    """The pairs run resumed at step 4 of its K=8 window either rebuilds at
    once (a file without its list, as the reference resumes) or, with the
    list and window in the file, rebuilds at step 8 as the uninterrupted
    run does."""
    carry = case.endswith("carried")
    if case == "sweep":   # the temperature pore, 6 + 6 against 12
        cfg = amt.temperature_pore_config(engine=amt.EngineConfig(
            dtype="float64", steps_per_epoch=6)).scaled_to(3000)
        total, split = 12, 6
    elif case.startswith("pairs"):   # K=8 resumed at step 4
        cfg = amt.temperature_pore_config(
            num_particles_override=2500, engine=amt.EngineConfig(
                dtype="float64", narrowphase="pairs", rebuild_interval=8,
                steps_per_epoch=4))
        total, split = 8, 4
    else:   # the cube with the all-pairs search, 10 + 10 against 20
        side = 40e-9   # ~1,600 particles at the published density
        cfg = amt.CubeConfig(geometry=amt.CubeGeometry(lx=side, ly=side,
                                                       lz=side),
                             engine=amt.EngineConfig(
                                 broadphase="allpairs", dtype="float64",
                                 steps_per_epoch=10))
        total, split = 20, 10
    whole, again, whole_met, again_met = resumed(
        simulation(cfg), total, split, tmp_path, carry_window=carry)
    assert_same_run(again, whole)
    assert int(whole[1].collision_count) > 0
    if case.startswith("pairs"):
        assert whole_met.rebuilt.tolist() == [1] + [0] * 7
        assert again_met.rebuilt.tolist() == ([0] * 4 if carry
                                              else [1, 0, 0, 0])


def test_float32_resume_is_bitwise(tmp_path):
    """The card's dtype, the main path's engine: pairs, K=8, resumed
    mid-window with the window carried."""
    cfg = amt.temperature_pore_config(engine=amt.EngineConfig(
        narrowphase="pairs", rebuild_interval=8,
        steps_per_epoch=5)).scaled_to(3000)
    whole, again, whole_met, again_met = resumed(
        simulation(cfg), 10, 5, tmp_path, carry_window=True)
    assert_same_run(again, whole)
    assert torch.equal(again_met.rebuilt, whole_met.rebuilt[5:])


def test_a_window_of_another_run_is_refused(tmp_path):
    cfg = amt.temperature_pore_config(engine=amt.EngineConfig(
        narrowphase="pairs", rebuild_interval=8)).scaled_to(2000)
    sim = amt.Simulation(amt.make_workload(cfg), device="cpu")
    state, _, _ = sim.run(num_steps=2)
    plist, left = sim.pair_window()
    assert left == 6
    other = amt.Simulation(amt.make_workload(
        amt.temperature_pore_config(engine=cfg.engine).scaled_to(3000)),
        device="cpu")
    with pytest.raises(ValueError, match="resume_pair_window"):
        other.resume_pair_window(state, plist, left)
    sweep = amt.Simulation(amt.make_workload(
        amt.temperature_pore_config().scaled_to(2000)), device="cpu")
    assert sweep.pair_window() is None
    with pytest.raises(ValueError, match="carries no pair list"):
        sweep.resume_pair_window(state, plist, left)


def sharded_sim(n=3000):
    cfg = amt.temperature_pore_config(engine=amt.EngineConfig(
        dtype="float64", steps_per_epoch=5)).scaled_to(n)
    return cfg, amt.ShardedSimulation(amt.make_workload(cfg), n_shards=2,
                                      devices=["cpu"])


def test_sharded_resume_is_bitwise(tmp_path):
    """2 CPU slabs: 5 + 5 steps against 10; valid and gid too, and every
    id live once."""
    cfg, sim = sharded_sim()
    state, meas, gens = sim.init()
    whole_state, whole_meas, _ = sim.run(num_steps=10, state=state,
                                         measure=meas, generators=gens)
    state, meas, gens = sim.init()
    state, meas, _ = sim.run(num_steps=5, state=state, measure=meas,
                             generators=gens)
    path = tckpt.save_sharded_checkpoint(str(tmp_path / "sh.npz"), state,
                                         meas, gens, 5)
    _, sim2 = sharded_sim()
    state, meas, gens, step = tckpt.load_sharded_checkpoint(path, ["cpu"] * 2)
    assert step == 5 and len(gens) == 2
    state, meas, _ = sim2.run(num_steps=5, state=state, measure=meas,
                              generators=gens, start_step=step)
    for (st, valid, gid), (ws, wvalid, wgid) in zip(state, whole_state):
        assert torch.equal(valid, wvalid) and torch.equal(gid, wgid)
        for f in STATE:
            assert torch.equal(getattr(st, f), getattr(ws, f)), f
    for m, wm in zip(meas, whole_meas):
        for f in MEASURE:
            assert torch.equal(getattr(m, f), getattr(wm, f)), f
    gids = torch.sort(torch.cat([gid[valid] for _, valid, gid in state]))
    assert torch.equal(gids.values, torch.arange(cfg.num_molecules,
                                                 dtype=torch.int32))


def test_sharded_pairs_resume_is_bitwise_mid_window(tmp_path):
    """2 CPU slabs in pairs mode (K=4): 6 + 6 steps against 12, the file
    written mid-window with each slab's PairWindow; a window for another
    slab count is refused."""
    cfg = amt.temperature_pore_config(engine=amt.EngineConfig(
        dtype="float64", steps_per_epoch=6, narrowphase="pairs",
        rebuild_interval=4)).scaled_to(3000)

    def make():
        return amt.ShardedSimulation(amt.make_workload(cfg), n_shards=2,
                                     devices=["cpu"])

    sim = make()
    whole_state, whole_meas, whole_met = sim.run(num_steps=12)
    sim = make()
    state, meas, gens = sim.init()
    state, meas, _ = sim.run(num_steps=6, state=state, measure=meas,
                             generators=gens)
    windows, left = sim.pair_window()
    assert left == 2 and len(windows) == 2
    path = tckpt.save_sharded_checkpoint(str(tmp_path / "shp.npz"), state,
                                         meas, gens, 6,
                                         pair_window=sim.pair_window())
    sim2 = make()
    state, meas, gens, step = tckpt.load_sharded_checkpoint(path, ["cpu"] * 2)
    sim2.resume_pair_window(state, *tckpt.load_sharded_pair_window(
        path, ["cpu"] * 2))
    state, meas, met = sim2.run(num_steps=6, state=state, measure=meas,
                                generators=gens, start_step=step)
    assert met.rebuilt.tolist() == whole_met.rebuilt.tolist()[6:]
    for (st, valid, gid), (ws, wvalid, wgid) in zip(state, whole_state):
        assert torch.equal(valid, wvalid) and torch.equal(gid, wgid)
        for f in STATE:
            assert torch.equal(getattr(st, f), getattr(ws, f)), f
    for m, wm in zip(meas, whole_meas):
        for f in MEASURE:
            assert torch.equal(getattr(m, f), getattr(wm, f)), f
    with pytest.raises(ValueError, match="slab windows"):
        tckpt.load_sharded_pair_window(path, ["cpu"] * 3)


def test_reference_reads_port_files(tmp_path):
    """The JAX loaders read the port's files: every array equal."""
    cfg = amt.temperature_pore_config(engine=amt.EngineConfig(
        dtype="float64", steps_per_epoch=3)).scaled_to(2000)
    sim = amt.Simulation(amt.make_workload(cfg), device="cpu")
    state, meas, gen = sim.init()
    state, meas, _ = sim.run(num_steps=3, state=state, measure=meas,
                             generator=gen)
    path = tckpt.save_checkpoint(str(tmp_path / "p.npz"), state, meas, gen, 3)
    js, jm, key, step = jckpt.load_checkpoint(path)
    assert step == 3 and np.asarray(key).tolist() == [0, 0]
    for f in STATE:
        np.testing.assert_array_equal(np.asarray(getattr(js, f)),
                                      getattr(state, f).numpy())
    for f in tckpt.MEASURE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jm, f)),
                                      getattr(meas, f).numpy())

    _, shsim = sharded_sim(2000)
    sstate, smeas, gens = shsim.init()
    sstate, smeas, _ = shsim.run(num_steps=3, state=sstate, measure=smeas,
                                 generators=gens)
    path = tckpt.save_sharded_checkpoint(str(tmp_path / "s.npz"), sstate,
                                         smeas, gens, 3)
    (jst, jvalid, jgid), jmeas, _, step = jckpt.load_sharded_checkpoint(path)
    assert step == 3
    np.testing.assert_array_equal(
        np.asarray(jst.pos), torch.cat([s.pos for s, _, _ in sstate]).numpy())
    np.testing.assert_array_equal(
        np.asarray(jvalid), torch.cat([v for _, v, _ in sstate]).numpy())
    np.testing.assert_array_equal(
        np.asarray(jgid), torch.cat([g for _, _, g in sstate]).numpy())
    for f in dataclasses.fields(amt.state.Measurements):
        np.testing.assert_array_equal(
            np.asarray(getattr(jmeas, f.name)),
            torch.stack([getattr(m, f.name) for m in smeas]).numpy())


def test_port_reads_reference_files(tmp_path):
    """The port loads the JAX package's files (single and sharded): the
    arrays equal, and a generator seeded from the file's run_key and step
    (the continuation draws the port's stream)."""
    jcfg = amc.temperature_pore_config(engine=JEngine(
        broadphase="cells", dtype="float64")).scaled_to(2000)
    jsim = amc.Simulation(amc.make_workload(jcfg))
    js, jm, key = jsim.init()
    path = jckpt.save_checkpoint(str(tmp_path / "j.npz"), js, jm, key, 7)
    assert tckpt.written_by_reference(path)
    state, meas, gen, step = tckpt.load_checkpoint(path, "cpu")
    assert step == 7 and state.pos.dtype == torch.float64
    for f in STATE:
        np.testing.assert_array_equal(getattr(state, f).numpy(),
                                      np.asarray(getattr(js, f)))
    for f in tckpt.MEASURE_FIELDS:
        np.testing.assert_array_equal(getattr(meas, f).numpy(),
                                      np.asarray(getattr(jm, f)))
    want = torch.Generator().manual_seed(tckpt.reference_seed(key, 7))
    assert torch.equal(torch.rand(5, generator=gen),
                       torch.rand(5, generator=want))

    jsh = JSharded(amc.make_workload(jcfg), mesh=make_mesh(4))
    (jst, jvalid, jgid), jmeas, key = jsh.init()
    path = jckpt.save_sharded_checkpoint(str(tmp_path / "js.npz"),
                                         (jst, jvalid, jgid), jmeas, key, 2)
    state, meas, gens, step = tckpt.load_sharded_checkpoint(path,
                                                            ["cpu"] * 4)
    assert step == 2 and len(state) == len(meas) == len(gens) == 4
    np.testing.assert_array_equal(
        torch.cat([v for _, v, _ in state]).numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(
        torch.cat([s.pos for s, _, _ in state]).numpy(), np.asarray(jst.pos))
    np.testing.assert_array_equal(
        torch.stack([m.pending_vals for m in meas]).numpy(),
        np.asarray(jmeas.pending_vals))
    draws = [torch.rand(3, generator=g) for g in gens]
    assert not torch.equal(draws[0], draws[1])   # one stream a slab


def test_mismatched_generator_device_is_refused(tmp_path):
    """A generator state resumes only on the kind of device that saved it;
    the error names both kinds (no tensor is built before it)."""
    cfg = amt.temperature_pore_config().scaled_to(1000)
    sim = amt.Simulation(amt.make_workload(cfg), device="cpu")
    state, meas, gen = sim.init()
    path = tckpt.save_checkpoint(str(tmp_path / "c.npz"), state, meas, gen, 0)
    with pytest.raises(ValueError, match="saved on a cpu device.*on a cuda"):
        tckpt.load_checkpoint(path, "cuda")
    with np.load(path) as z:
        arrays = dict(z)
    arrays["generator_device"] = np.asarray("cuda")
    np.savez(str(tmp_path / "d.npz"), **arrays)
    with pytest.raises(ValueError, match="saved on a cuda device.*on a cpu"):
        tckpt.load_checkpoint(str(tmp_path / "d.npz"), "cpu")

    _, shsim = sharded_sim(1000)
    sstate, smeas, gens = shsim.init()
    path = tckpt.save_sharded_checkpoint(str(tmp_path / "s.npz"), sstate,
                                         smeas, gens, 0)
    with pytest.raises(ValueError, match="saved on a cpu device.*on a cuda"):
        tckpt.load_sharded_checkpoint(path, ["cpu", "cuda"])
