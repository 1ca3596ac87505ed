"""The steps update their own tensors in place: the temperature pore's
steps through K8, the specular pore's through K14, the pairs step through
K3, K4 and K7's compacted entry, the sweep, the cube and the z-slab engine
through K10 and K7's dense entry.  What that leans on and what it must
not touch, on the CPU with the plain twins, in both pores' pairs mode and
in the temperature pore's sweep, the cube and 2-slab sharded runs:

- ``Simulation.run`` and ``ShardedSimulation.run`` copy what their caller
  hands them, so the caller's state and measurements stay bitwise as they
  were, also across runs that carry the pair list;
- the staging keeps a row whose mask is clear at zero whenever a step
  flushes it, so either flush may clear only the staged rows, and the
  staging is empty after each flush; the events the compacted flush is
  given ascend;
- K10 writes the tensors it is given, in every caller, and on a slab no
  ghost lane;
- K8 (and K14, the specular pore's) returns and updates the state and
  staging it is given, in every caller, and leaves a slab's staging rows
  past its lanes alone.
"""

import dataclasses

import pytest
import torch

import argon_monte_carlo_tpu_torch as amt
from argon_monte_carlo_tpu_torch.engine import copy_tensors
from argon_monte_carlo_tpu_torch.ops import measure as tmeasure
from argon_monte_carlo_tpu_torch.ops import pore_pass

TARGET = 3000
K = 4
PORES = {"temperature": amt.temperature_pore_config, "specular": amt.PoreConfig}


def pairs_sim(pore):
    cfg = PORES[pore](num_particles_override=TARGET,
                      engine=amt.EngineConfig(narrowphase="pairs",
                                              rebuild_interval=K,
                                              steps_per_epoch=K))
    return amt.Simulation(amt.make_workload(cfg), device="cpu")


def start(sim):
    """The initial state with every particle's partial path already ended,
    so every pair collision stages a completed path; the measurements and
    the Generator that goes on to draw the steps."""
    state, meas, gen = sim.init()
    state = dataclasses.replace(
        state, has_collided=torch.ones_like(state.has_collided))
    return state, meas, gen


def snapshot(obj):
    return {f.name: getattr(obj, f.name).clone()
            for f in dataclasses.fields(obj)}


def assert_as_snapshot(obj, snap):
    for name, kept in snap.items():
        assert torch.equal(getattr(obj, name), kept), name


@pytest.mark.parametrize("pore", sorted(PORES))
def test_run_leaves_callers_state_and_measurements_untouched(pore):
    """Two runs of the pairs engine, the second on what the first returned
    (the window and the pair list carry over): neither run writes a tensor
    it was handed, and the carried run equals one run of all the steps."""
    sim = pairs_sim(pore)
    state, meas, gen = start(sim)
    given_state, given_meas = snapshot(state), snapshot(meas)
    s1, m1, met1 = sim.run(num_steps=6, state=state, measure=meas,
                           generator=gen)
    assert_as_snapshot(state, given_state)
    assert_as_snapshot(meas, given_meas)
    assert int(m1.collision_count) > 0 and int(m1.path_count) > 0
    first_state, first_meas = snapshot(s1), snapshot(m1)
    s2, m2, met2 = sim.run(num_steps=6, state=s1, measure=m1, generator=gen,
                           start_step=6)
    assert_as_snapshot(s1, first_state)
    assert_as_snapshot(m1, first_meas)
    assert met1.rebuilt.tolist() + met2.rebuilt.tolist() == [1, 0, 0, 0] * 3

    # The caller's initial state, never written, starts the whole run.
    _, _, gen = sim.init()
    whole, whole_meas, _ = sim.run(num_steps=12, state=state, measure=meas,
                                   generator=gen)
    for f in ("pos", "vel", "paths", "has_collided"):
        assert torch.equal(getattr(s2, f), getattr(whole, f)), f
    for f in ("hist", "path_sum", "path_count", "collision_count"):
        assert torch.equal(getattr(m2, f), getattr(whole_meas, f)), f


@pytest.mark.parametrize("pore", sorted(PORES))
def test_unstaged_rows_are_zero_at_every_flush(pore, monkeypatch):
    """At every flush of the pairs step a row of the staging whose mask is
    clear is zero (the writers stage a row only where they set its mask,
    and every flush clears what was staged), and the engine's event_idx
    ascends."""
    flush = tmeasure.flush_hist_compacted
    seen = []

    def spy(measure, event_idx, num_bins, hist_hi):
        vals, mask = measure.pending_vals, measure.pending_mask
        assert not vals[~mask].any()
        tmeasure.check_event_idx(event_idx, vals.shape[0])
        seen.append(int(mask.sum()))
        out = flush(measure, event_idx, num_bins, hist_hi)
        assert not out.pending_vals.any() and not out.pending_mask.any()
        return out

    monkeypatch.setattr(tmeasure, "flush_hist_compacted", spy)
    sim = pairs_sim(pore)
    state, meas, gen = start(sim)
    _, meas, _ = sim.run(num_steps=12, state=state, measure=meas,
                         generator=gen)
    assert len(seen) == 12
    assert sum(seen) == int(meas.path_count) > 0


# The callers of K7's dense entry: the temperature pore's sweep, the cube
# and the sweep cut in two z-slabs.
DENSE = ("sweep", "cube", "sharded")


def dense_sim(kind):
    engine = amt.EngineConfig(steps_per_epoch=3)
    if kind == "cube":
        cfg = amt.CubeConfig(num_particles_override=TARGET, engine=dataclasses
                             .replace(engine, broadphase="allpairs"))
        return amt.Simulation(amt.make_workload(cfg), device="cpu")
    cfg = amt.temperature_pore_config(num_particles_override=TARGET,
                                      engine=engine)
    if kind == "sweep":
        return amt.Simulation(amt.make_workload(cfg), device="cpu")
    return amt.ShardedSimulation(amt.make_workload(cfg), n_shards=2,
                                 devices=["cpu"])


def dense_start(sim):
    """As ``start``: every particle's partial path already ended; for the
    sharded engine, each slab's."""
    if isinstance(sim, amt.ShardedSimulation):
        state, meas, gens = sim.init()
        state = [(dataclasses.replace(
            st, has_collided=torch.ones_like(st.has_collided)), valid, gid)
            for st, valid, gid in state]
        return state, meas, dict(generators=gens)
    state, meas, gen = start(sim)
    return state, meas, dict(generator=gen)


def snapshot_all(state, meas):
    """Every tensor the caller holds: one state and measurements, or the
    sharded engine's lists of (state, valid, gid) and measurements."""
    if isinstance(meas, list):
        return ([(snapshot(st), valid.clone(), gid.clone())
                 for st, valid, gid in state], [snapshot(m) for m in meas])
    return snapshot(state), snapshot(meas)


def assert_all_as_snapshot(state, meas, snap):
    if isinstance(meas, list):
        for (st, valid, gid), (s_st, s_valid, s_gid) in zip(state, snap[0]):
            assert_as_snapshot(st, s_st)
            assert torch.equal(valid, s_valid) and torch.equal(gid, s_gid)
        for m, s_m in zip(meas, snap[1]):
            assert_as_snapshot(m, s_m)
    else:
        assert_as_snapshot(state, snap[0])
        assert_as_snapshot(meas, snap[1])


@pytest.mark.parametrize("kind", DENSE)
def test_dense_flush_runs_leave_callers_tensors_untouched(kind):
    """Two runs through K7's dense entry, the second on what the first
    returned: neither writes a tensor it was handed, the histogram got
    events, and the carried run equals one run of all the steps."""
    sim = dense_sim(kind)
    state, meas, gens = dense_start(sim)
    given = snapshot_all(state, meas)
    s1, m1, _ = sim.run(num_steps=3, state=state, measure=meas, **gens)
    assert_all_as_snapshot(state, meas, given)
    totals = m1 if isinstance(m1, list) else [m1]
    assert sum(int(m.path_count) for m in totals) > 0
    first = snapshot_all(s1, m1)
    s2, m2, _ = sim.run(num_steps=3, state=s1, measure=m1, start_step=3,
                        **gens)
    assert_all_as_snapshot(s1, m1, first)

    # The caller's initial state, never written, starts the whole run.
    _, _, gens = dense_start(sim)
    whole, whole_meas, _ = sim.run(num_steps=6, state=state, measure=meas,
                                   **gens)
    assert_all_as_snapshot(s2, m2, snapshot_all(whole, whole_meas))


@pytest.mark.parametrize("kind", DENSE)
def test_unstaged_rows_are_zero_at_every_dense_flush(kind, monkeypatch):
    """At every dense flush a row of the staging whose mask is clear is
    zero, and after it the staging is empty; every flush returns the
    measurements it was given."""
    flush = tmeasure.flush_hist
    seen = []

    def spy(measure, num_bins, hist_hi, capacity=tmeasure.FLUSH_CAPACITY):
        vals, mask = measure.pending_vals, measure.pending_mask
        assert not vals[~mask].any()
        seen.append(int(mask.sum()))
        out = flush(measure, num_bins, hist_hi, capacity)
        assert out is measure
        assert not out.pending_vals.any() and not out.pending_mask.any()
        return out

    monkeypatch.setattr(tmeasure, "flush_hist", spy)
    sim = dense_sim(kind)
    state, meas, gens = dense_start(sim)
    _, meas, _ = sim.run(num_steps=6, state=state, measure=meas, **gens)
    slabs = 2 if kind == "sharded" else 1
    assert len(seen) == 6 * slabs
    totals = meas if isinstance(meas, list) else [meas]
    assert sum(seen) == sum(int(m.path_count) for m in totals) > 0


def k10_sim(kind):
    """K10's callers at a density where pairs collide every few steps: the
    temperature pore scaled to TARGET particles (the sweep, and cut in two
    z-slabs), and the cube."""
    if kind == "cube":
        return dense_sim(kind)
    cfg = amt.temperature_pore_config(
        engine=amt.EngineConfig(steps_per_epoch=3)).scaled_to(TARGET)
    if kind == "sweep":
        return amt.Simulation(amt.make_workload(cfg), device="cpu")
    return amt.ShardedSimulation(amt.make_workload(cfg), n_shards=2,
                                 devices=["cpu"])


@pytest.mark.parametrize("kind", DENSE)
def test_resolve_pairs_writes_the_steps_own_tensors(kind, monkeypatch):
    """K10 in every caller (the sweep, the cube, each slab's combined
    lanes) updates the tensors it is given and returns them, writes no
    ghost lane of a slab and none of the caller's tensors, and resolves
    pairs; the sweep and the cube hand it a count, a slab none."""
    from argon_monte_carlo_tpu_torch.ops import collide as tcollide
    resolve = tcollide.resolve_pairs
    applied = []

    def spy(state, measure, partner, cr, count=None, local_mask=None):
        before = snapshot(state)
        out = resolve(state, measure, partner, cr, count=count,
                      local_mask=local_mask)
        assert out[0] is state and out[1] is measure
        changed = (state.pos != before["pos"]).any(1)
        if local_mask is None:
            assert count is not None and out[2] is count
        else:
            assert count is None and out[2] is None
            assert not changed[~local_mask].any()
        applied.append(int(changed.sum()))
        return out

    monkeypatch.setattr(tcollide, "resolve_pairs", spy)
    sim = k10_sim(kind)
    state, meas, gens = dense_start(sim)
    given = snapshot_all(state, meas)
    steps = 6
    sim.run(num_steps=steps, state=state, measure=meas, **gens)
    assert_all_as_snapshot(state, meas, given)
    slabs = 2 if kind == "sharded" else 1
    assert len(applied) == steps * slabs and sum(applied) > 0


# K8's callers: the temperature pore's pairs step and sweep, and both cut
# in two z-slabs; K14's (the specular pore's wrapper): its pairs step, and
# cut in two z-slabs.
K8_KINDS = ("pairs", "sweep", "sharded pairs", "sharded sweep",
            "specular pairs", "specular sharded pairs")
K8_FIELDS = ("pos", "vel", "paths", "has_collided")


def k8_sim(kind):
    engine = (amt.EngineConfig(narrowphase="pairs", rebuild_interval=K,
                               steps_per_epoch=3)
              if kind.endswith("pairs") else
              amt.EngineConfig(steps_per_epoch=3))
    pore = (amt.PoreConfig if kind.startswith("specular")
            else amt.temperature_pore_config)
    kind = kind.removeprefix("specular ")
    cfg = pore(engine=engine).scaled_to(TARGET)
    if kind.startswith("sharded"):
        return amt.ShardedSimulation(amt.make_workload(cfg), n_shards=2,
                                     devices=["cpu"])
    return amt.Simulation(amt.make_workload(cfg), device="cpu")


@pytest.mark.parametrize("kind", K8_KINDS)
def test_pore_advance_writes_the_steps_own_tensors(kind, monkeypatch):
    """K8's wrapper (K14's for the specular pore) in every caller returns
    the state and measurements it was given, with their pos, vel, paths,
    has_collided and the first n staging rows updated to what the plain
    version computes on copies, a slab's staging rows past its lanes as
    they were; no tensor of the run's caller is written."""
    wrapper = ("specular_advance" if kind.startswith("specular")
               else "pore_advance")
    advance = getattr(pore_pass, wrapper)
    rows_past = []

    def spy(state, measure, uniforms, params, plain, missed=None):
        want = plain(copy_tensors(state), copy_tensors(measure), uniforms)
        n = state.pos.shape[0]
        given = {f: getattr(state, f) for f in K8_FIELDS}
        staging = (measure.pending_vals, measure.pending_mask)
        past = [t[n:].clone() for t in staging]
        out = advance(state, measure, uniforms, params, plain, missed=missed)
        assert out[0] is state and out[1] is measure
        for f, t in given.items():
            assert getattr(state, f) is t
            assert torch.equal(t, getattr(want[0], f)), f
        assert (measure.pending_vals, measure.pending_mask) == staging
        for t, w, kept in zip(staging, (want[1].pending_vals,
                                        want[1].pending_mask), past):
            assert torch.equal(t[:n], w[:n]) and torch.equal(t[n:], kept)
        for a, b in zip(out[2:], want[2:]):
            assert all(torch.equal(x, y) for x, y in zip(
                *(v if isinstance(v, tuple) else (v,) for v in (a, b))))
        rows_past.append(measure.pending_vals.shape[0] - n)
        return out

    monkeypatch.setattr(pore_pass, wrapper, spy)
    sim = k8_sim(kind)
    state, meas, gens = dense_start(sim)
    given = snapshot_all(state, meas)
    steps = 5
    sim.run(num_steps=steps, state=state, measure=meas, **gens)
    assert_all_as_snapshot(state, meas, given)
    slabs = 2 if "sharded" in kind else 1
    assert len(rows_past) == steps * slabs
    assert (min(rows_past) > 0) if slabs == 2 else (set(rows_past) == {0})



def test_pore_advance_leaves_staging_rows_past_the_particles():
    """A staging longer than the state (a slab's ghost rows), its rows
    past the particles planted with values: the wrapper updates the first
    n rows as the plain version does and leaves the rest bitwise."""
    sim = k8_sim("pairs")
    state, meas, gen = start(sim)
    n = state.num_particles
    ghost = torch.rand((257, 4), generator=gen, dtype=state.pos.dtype)
    meas = dataclasses.replace(
        meas, pending_vals=torch.cat([meas.pending_vals, ghost]),
        pending_mask=torch.cat([meas.pending_mask, ghost[:, 0] > 0.5]))
    u = torch.rand((n, 2), generator=gen, dtype=state.pos.dtype)
    wl = sim.workload
    want = wl.advance_plain(copy_tensors(state), copy_tensors(meas), u)
    before = snapshot(meas)
    out = wl.advance(state, meas, u)
    assert out[1] is meas and int(meas.pending_mask[:n].sum()) > 0
    for f in ("pending_vals", "pending_mask"):
        t = getattr(meas, f)
        assert torch.equal(t[:n], getattr(want[1], f)[:n])
        assert torch.equal(t[n:], before[f][n:])
        assert not torch.equal(t[:n], before[f][:n])


def test_sharded_pairs_runs_leave_callers_tensors_untouched():
    """Two runs of the sharded pairs mode, the second on what the first
    returned: neither writes a tensor it was handed (K8 and K3 update the
    slabs' own copies), and the carried run equals one run of all the
    steps."""
    sim = k8_sim("sharded pairs")
    state, meas, gens = dense_start(sim)
    given = snapshot_all(state, meas)
    s1, m1, _ = sim.run(num_steps=3, state=state, measure=meas, **gens)
    assert_all_as_snapshot(state, meas, given)
    first = snapshot_all(s1, m1)
    s2, m2, _ = sim.run(num_steps=3, state=s1, measure=m1, start_step=3,
                        **gens)
    assert_all_as_snapshot(s1, m1, first)
    _, _, gens = dense_start(sim)
    whole, whole_meas, _ = sim.run(num_steps=6, state=state, measure=meas,
                                   **gens)
    assert_all_as_snapshot(s2, m2, snapshot_all(whole, whole_meas))
