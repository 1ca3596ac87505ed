"""K13's plain twin -- the pairs step's post-pairs recapture and dirty
masks, ``ops/post_pairs.post_pairs_plain`` -- against the sequence the
pairs step ran inline before it (``inline_stages`` below, that code as it
was), and the kernel's wrapper against its C declaration.

The inputs are ``chip_smoke.post_pairs_case``'s: the pore's initial state
with rows planted in every branch of the recapture and on the edges
between them, and drawn patterns of hot, pending1, collided, recap_w, the
staging mask and speeds one ulp off.  Both pores (the temperature pore's
recapture and the specular pore's audit and nudge), both dtypes; every
comparison bitwise.  The twin with a z-slab's lane masks is held the same
way to the stages ``ShardedSimulation._pairs_step`` ran inline before it
(``slab_inline_stages``), on local, ghost and invalid lanes of one case.
"""

import ctypes
import dataclasses
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import argon_monte_carlo_tpu_torch as amt
from argon_monte_carlo_tpu_torch import kernels
from argon_monte_carlo_tpu_torch.ops import measure as measure_ops
from argon_monte_carlo_tpu_torch.ops import post_pairs as post_ops
from argon_monte_carlo_tpu_torch.ops.pack import SENTINEL
from argon_monte_carlo_tpu_torch.parallel.shard import ShardedSimulation

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

N = 3000


def inline_stages(recapture, state, measure, plist, speed_pre, collided,
                  recap_w):
    """The pairs step's recapture and dirty stages as they ran inline in
    ``engine.make_pairs_step_fn``, with their counters: (state, plist,
    bump, dirty, the shared compaction's mask, oob_after_pairs,
    latent_full, dirty_count, teleports)."""
    pos_pre = state.pos
    state, oob_pairs = recapture(state)
    recap_p = torch.any(state.pos != pos_pre, dim=-1)
    bump = (measure_ops.speed(state.vel) != speed_pre) | collided
    hot = plist.hot | recap_w | recap_p
    latent_full = torch.sum(plist.pending1, dtype=torch.int32)
    dirty = bump | hot | plist.pending1
    shared = measure.pending_mask | dirty
    plist = dataclasses.replace(plist, hot=hot)
    plist = dataclasses.replace(plist,
                                pending1=torch.zeros_like(plist.pending1))
    return (state, plist, bump, dirty, shared, oob_pairs, latent_full,
            torch.sum(dirty, dtype=torch.int32),
            torch.sum(recap_w | recap_p, dtype=torch.int32))


def case(energized, dtype, seed=11):
    wl, state, meas, plist, sp, col, rw = chip_smoke.post_pairs_case(
        N, seed, "cpu", energized=energized)
    if dtype == torch.float64:
        state = dataclasses.replace(state, pos=state.pos.double(),
                                    vel=state.vel.double())
        sp = measure_ops.speed(state.vel)
        gen = torch.Generator().manual_seed(seed)
        sp = torch.where(torch.rand(N, generator=gen) < 0.05,
                         torch.nextafter(sp, torch.zeros_like(sp)), sp)
    return wl, state, meas, plist, sp, col, rw


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("energized", [True, False])
def test_plain_twin_equals_the_inline_stages(energized, dtype):
    wl, state, meas, plist, sp, col, rw = case(energized, dtype)
    got = post_ops.post_pairs_plain(wl.post_pairs, state, meas, plist, sp,
                                    col, rw)
    want = inline_stages(wl.post_pairs, state, meas, plist, sp, col, rw)
    ws, wp, bump, dirty, shared, oob, latent, dcount, tele = want
    pairs = [("pos", got.state.pos, ws.pos), ("hot", got.plist.hot, wp.hot),
             ("pending1", got.plist.pending1, wp.pending1),
             ("bump", got.bump, bump), ("dirty", got.dirty, dirty),
             ("shared", got.shared, shared),
             ("oob_after_pairs", got.oob_after_pairs, oob),
             ("latent_full", got.latent_full, latent),
             ("dirty_count", got.dirty_count, dcount),
             ("teleports", got.teleports, tele)]
    for name, a, b in pairs:
        assert chip_smoke.bits_equal(a, b), name
    # The twin leaves its inputs alone and the rest of the list as it was.
    for f in dataclasses.fields(plist):
        if f.name not in ("hot", "pending1"):
            assert getattr(got.plist, f.name) is getattr(plist, f.name)
    assert not bool(got.plist.pending1.any())
    # Every pattern occurs: recaptured, moved and not taken (NaN),
    # teleported by either recapture, bumped by speed alone and by a
    # collision alone, queued, hot without a change.
    assert int(oob) > 0 and int(tele) > int(rw.sum())
    assert int(latent) > 0 and int(dcount) > int(bump.sum())
    same_speed = sp == measure_ops.speed(state.vel)
    assert bool((bump & ~col).any()) and bool((col & same_speed).any())


def slab_inline_stages(recapture, state, measure, plist, wall_bump,
                       collided, recap_w, valid, local, cap):
    """The slab pairs step's recapture and dirty stages as they ran inline
    in ``ShardedSimulation._pairs_step``, with its counters, in
    ``inline_stages``'s order.  ``wall_bump`` (the speed changed in the
    wall stage) and ``recap_w`` are each lane's own or, for a ghost, its
    owner's flags, as the export carried them: masked by ``valid``."""
    pos_pre = state.pos
    state, _ = recapture(state)
    recap_p = torch.any(state.pos != pos_pre, dim=-1)
    oob_pairs = torch.sum(recap_p[:cap] & valid[:cap], dtype=torch.int32)
    bump = (wall_bump | collided) & valid
    teleported = recap_w | recap_p
    hot = plist.hot | (teleported & valid)
    latent_full = torch.sum(plist.pending1 & local, dtype=torch.int32)
    dirty = (bump | hot | plist.pending1) & valid
    shared = measure.pending_mask | dirty
    plist = dataclasses.replace(plist, hot=hot,
                                pending1=torch.zeros_like(plist.pending1))
    return (state, plist, bump, dirty, shared, oob_pairs, latent_full,
            torch.sum(dirty, dtype=torch.int32),
            torch.sum(teleported & local, dtype=torch.int32))


def slab_case(energized):
    """``case`` cut as a slab: lanes below ``cap`` local (every 11th from
    lane 5 empty, a planted row among them), the rest ghosts (every third
    slot empty, as the export fills it: far, at rest, speed 0, no flag).
    K3 has changed the velocity of half the collided lanes since the wall
    stage.  Returns (workload, recapture under parking, the post-K3 state,
    measure, plist, the post-wall velocity, speed_pre, collided, recap_w,
    valid, local, cap)."""
    wl, state, meas, plist, sp, col, rw = case(energized, torch.float32)
    n, cap = N, 2000
    lane = torch.arange(n)
    ghost = lane >= cap
    valid = torch.where(ghost, lane % 3 != 0, lane % 11 != 5)
    local = valid & ~ghost
    empty = ghost & ~valid
    state = dataclasses.replace(
        state, pos=torch.where(empty[:, None], SENTINEL, state.pos),
        vel=torch.where(empty[:, None], 0.0, state.vel))
    sp = torch.where(empty, 0.0, sp)
    rw = rw & ~empty
    gen = torch.Generator().manual_seed(5)
    changed = col & (torch.rand(n, generator=gen) < 0.5)
    vel_wall = torch.where(changed[:, None], 0.75 * state.vel, state.vel)
    h = wl.cfg.geometry.total_height
    parking = SimpleNamespace(park=torch.tensor([0.0, 0.0, 0.5 * h]),
                              far=torch.tensor(SENTINEL))

    def recapture(st):
        return ShardedSimulation._parked(None, parking, st, valid,
                                         wl.post_pairs)

    return (wl, recapture, state, meas, plist, vel_wall, sp, col, rw, valid,
            local, cap)


@pytest.mark.parametrize("energized", [True, False])
def test_masked_twin_equals_the_slab_inline_stages(energized):
    (wl, recapture, state, meas, plist, vel_wall, sp, col, rw, valid, local,
     cap) = slab_case(energized)
    got = post_ops.post_pairs_plain(recapture, state, meas, plist, sp, col,
                                    rw, valid=valid, local=local)
    wall_bump = (measure_ops.speed(vel_wall) != sp) & valid
    want = slab_inline_stages(recapture, state, meas, plist, wall_bump, col,
                              rw & valid, valid, local, cap)
    ws, wp, bump, dirty, shared, oob, latent, dcount, tele = want
    pairs = [("pos", got.state.pos, ws.pos), ("hot", got.plist.hot, wp.hot),
             ("pending1", got.plist.pending1, wp.pending1),
             ("bump", got.bump, bump), ("dirty", got.dirty, dirty),
             ("shared", got.shared, shared),
             ("oob_after_pairs", got.oob_after_pairs, oob),
             ("latent_full", got.latent_full, latent),
             ("dirty_count", got.dirty_count, dcount),
             ("teleports", got.teleports, tele)]
    for name, a, b in pairs:
        assert chip_smoke.bits_equal(a, b), name
    for f in dataclasses.fields(plist):
        if f.name not in ("hot", "pending1"):
            assert getattr(got.plist, f.name) is getattr(plist, f.name)
    # Every kind of lane is there: moved by the recapture where local, a
    # valid ghost and an empty local lane (which the parking moves far);
    # queued, teleported and dirty local and ghost lanes; and the lanes
    # whose speed K3 changed since the wall stage.
    moved = (got.state.pos != state.pos).any(dim=1)
    ghost = torch.arange(N) >= cap
    for lanes in (local, valid & ghost, ~valid & ~ghost):
        assert bool((moved & lanes).any())
    for mask in (plist.pending1, rw, got.dirty, got.bump):
        assert bool((mask & local).any()) and bool((mask & valid & ghost)
                                                   .any())
    assert not bool((got.dirty & ~valid).any())
    assert bool((plist.pending1 & ~valid).any())
    assert 0 < int(oob) < int(moved.sum())
    assert int(dcount) > int(torch.sum(got.dirty & local))
    assert bool((col & (measure_ops.speed(vel_wall)
                        != measure_ops.speed(state.vel))).any())


@pytest.mark.parametrize("energized", [True, False])
def test_planted_rows_take_the_conditions_they_name(energized):
    """The planted rows alone: the recapture's count is the table's sum,
    and each row moves exactly where the table says it takes a condition
    (the NaN row aside, which moves by comparison and takes none)."""
    wl, state, *_ = case(energized, torch.float32)
    geom = wl.cfg.geometry
    rows, conditions = chip_smoke.planted_rows(geom)
    pos = torch.as_tensor(rows, dtype=torch.float32)
    moved_state, count = wl.post_pairs(
        dataclasses.replace(state, pos=pos, vel=state.vel[:len(rows)],
                            paths=state.paths[:len(rows)],
                            has_collided=state.has_collided[:len(rows)]))
    taken = np.array([r[3] for r in chip_smoke.PLANTED])
    moved = (moved_state.pos != pos).any(dim=1).numpy()
    nan_row = np.isnan(rows).any(axis=1)
    assert np.array_equal(moved[~nan_row], taken[~nan_row] > 0)
    assert int(count) == conditions


@pytest.mark.parametrize("energized", [True, False])
def test_cpu_pairs_run_launches_no_post_pairs(energized):
    cfg = (amt.temperature_pore_config if energized else amt.PoreConfig)(
        engine=amt.EngineConfig(narrowphase="pairs", rebuild_interval=4,
                                steps_per_epoch=6)).scaled_to(2000)
    sim = amt.Simulation(amt.make_workload(cfg), device="cpu")
    kernels.launch_counts.clear()
    _, _, metrics = sim.run(num_steps=12)
    assert kernels.launch_counts["post_pairs"] == 0
    assert int(metrics.dirty_count.sum()) > 0


def test_workloads_with_the_kernel():
    """Only the temperature pore has K13; the pairs step runs the twin for
    the others."""
    pore = amt.make_workload(amt.temperature_pore_config().scaled_to(2000))
    spec = amt.make_workload(amt.PoreConfig().scaled_to(2000))
    cube = amt.make_workload(amt.CubeConfig(num_particles_override=500))
    assert pore.post_pairs_stage is not None
    assert spec.post_pairs_stage is None and cube.post_pairs_stage is None


def test_temperature_pore_stage_on_cpu_is_the_twin():
    wl, state, meas, plist, sp, col, rw = case(True, torch.float32)
    got = wl.post_pairs_stage(state, meas, plist, sp, col, rw)
    want = post_ops.post_pairs_plain(wl.post_pairs, state, meas, plist, sp,
                                     col, rw)
    g, w = (chip_smoke.post_pairs_outputs(o) for o in (got, want))
    assert all(chip_smoke.bits_equal(g[k], w[k]) for k in g)


def test_wrapper_passes_declared_arguments(monkeypatch):
    """Forced down its kernel side with the launch intercepted: exactly
    the declared argument kinds, the tensors it was given for pos, hot and
    pending1, and outputs of the declared shapes."""
    given = {}

    def fake_launch(name, device, *args):
        given[name] = args
        sig = kernels._SIGNATURES[name][:-1]  # the stream is launch's
        assert len(args) == len(sig)
        for arg, kind in zip(args, sig):
            want = {ctypes.c_void_p: ctypes.c_void_p, ctypes.c_int: int,
                    ctypes.c_float: float}[kind]
            assert isinstance(arg, want), (arg, kind)

    wl, state, meas, plist, sp, col, rw = case(True, torch.float32)
    monkeypatch.setattr(kernels, "use_plain", lambda t: False)
    monkeypatch.setattr(kernels, "launch", fake_launch)
    out = wl.post_pairs_stage(state, meas, plist, sp, col, rw)
    args = given["post_pairs"]
    assert args[0].value == state.pos.data_ptr()
    assert args[5].value == plist.hot.data_ptr()
    assert args[6].value == plist.pending1.data_ptr()
    assert args[9] == N
    assert out.state is state and out.plist is plist
    for t in (out.bump, out.dirty, out.shared):
        assert t.dtype == torch.bool and t.shape == (N,) and t.is_contiguous()
    assert [args[k].value for k in (10, 11, 12)] == [
        out.bump.data_ptr(), out.dirty.data_ptr(), out.shared.data_ptr()]
    for k, t in enumerate((out.oob_after_pairs, out.latent_full,
                           out.dirty_count, out.teleports)):
        assert t.dtype == torch.int32 and t.shape == ()
        assert t.data_ptr() == args[13].value + 4 * k


@pytest.mark.parametrize("field, bad", [
    ("pos", lambda t: t.double()),
    ("speed_pre", lambda t: t[:-1]),
    ("hot", lambda t: t.to(torch.uint8)),
    ("pending_mask", lambda t: torch.cat([t, t[:1]])),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch, field,
                                                       bad):
    def no_launch(*args):
        raise AssertionError("launched")

    wl, state, meas, plist, sp, col, rw = case(True, torch.float32)
    if field == "pos":
        state = dataclasses.replace(state, pos=bad(state.pos))
    elif field == "speed_pre":
        sp = bad(sp)
    elif field == "hot":
        plist = dataclasses.replace(plist, hot=bad(plist.hot))
    else:
        meas = dataclasses.replace(meas, pending_mask=bad(meas.pending_mask))
    monkeypatch.setattr(kernels, "use_plain", lambda t: False)
    monkeypatch.setattr(kernels, "launch", no_launch)
    with pytest.raises((TypeError, ValueError)):
        wl.post_pairs_stage(state, meas, plist, sp, col, rw)


def test_kernel_shares_k8s_recapture():
    """K13 and K8 call one recapture on one set of constants: the header's
    ``enum Param`` and ``recapture``, defined in neither kernel's file."""
    csrc = kernels.CSRC
    for name in ("post_pairs.cu", "pore_walls.cu"):
        src = (csrc / name).read_text()
        assert '#include "pore_recapture.cuh"' in src
        assert "recapture(c, x, y, z)" in src
        assert "enum Param {" not in src
    header = (csrc / "pore_recapture.cuh").read_text()
    assert header.count("enum Param {") == 1
    assert "int recapture(" in header
