"""``correct`` comes out false where it must: the control (the reference
in bfloat16, from the same draws) against the limits of every cell, and a
run whose timed path is broken underneath -- a step that returns its state
unchanged, half of the particles left out of the step, an answer altered
where it is produced, a particle or a path dropped every step.  (One
card: there is no exchange between chips to leave out.)  A sound run at
the same size comes out true."""

import dataclasses
import json
import time

import pytest

import calibrate
import correct
import harness

from argon_monte_carlo_tpu_torch import engine

CELLS = ("tpore-1m.pairs", "tpore-1m.sweep", "cube.allpairs")


def _limits(small_bench, cell):
    return json.loads((small_bench / "limits" / f"{cell}.json")
                      .read_text())["numbers"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(small_bench, cell):
    out = calibrate.readings(cell, [], [11, 12, 13], device="cpu",
                             bench_dir=small_bench, emit=lambda _: None)
    # The control follows the compared epoch alone: its numbers, not the
    # counters of the steps after it.
    for _, seed, values in out:
        limits = {k: v for k, v in _limits(small_bench, cell).items()
                  if k in values}
        ok, checked = correct.judge(values, limits)
        assert not ok, (seed, checked)


def _copy(state):
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).clone()
        for f in dataclasses.fields(state)})


def _half(before, after):
    """The step's result on the first half of the particles, the state
    before it on the rest."""
    n = before.pos.shape[0] // 2
    for f in dataclasses.fields(after):
        getattr(after, f.name)[n:] = getattr(before, f.name)[n:]
    return after


def _broken(kind, cube):
    """A make_step_fn / make_pairs_step_fn wrapper that breaks the step."""
    def wrap(make):
        def made(*args, **kwargs):
            real = make(*args, **kwargs)

            def step(state, measure, *rest):
                before = _copy(state)
                out = list(real(state, measure, *rest))
                if kind == "unchanged":
                    out[0] = before
                elif kind == "half":
                    out[0] = _half(before, out[0])
                elif cube:   # the histogram flush miscounts a path
                    out[1].hist[0, 0] += 1.0
                else:        # the ledger's momentum is off by a tenth
                    m = out[-1]
                    out[-1] = dataclasses.replace(
                        m, momentum_z=m.momentum_z * 1.1)
                return tuple(out)
            return step
        return made
    return wrap


def _run(small_bench, cell):
    return harness.run_cell(
        ["--workload", cell, "--seed", "2718281828", "--seconds", "0.1",
         "--trace", "0"], time.perf_counter(), device="cpu",
        bench_dir=small_bench)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(small_bench, cell):
    assert _run(small_bench, cell)["correct"] is True


@pytest.mark.parametrize("kind", ("unchanged", "half", "altered"))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_step_is_not_correct(small_bench, monkeypatch, cell, kind):
    cube = cell.startswith("cube")
    for name in ("make_step_fn", "make_pairs_step_fn"):
        monkeypatch.setattr(engine, name,
                            _broken(kind, cube)(getattr(engine, name)))
    out = _run(small_bench, cell)
    assert out["correct"] is False, out["checked"]


@pytest.mark.parametrize("counter", ("overflow_count", "hist_drop_count"))
@pytest.mark.parametrize("cell", CELLS)
def test_dropped_after_the_first_epoch_is_not_correct(small_bench,
                                                      monkeypatch, cell,
                                                      counter):
    """A step that counts a particle dropped from the collision search, or
    a path dropped from the histogram: the window's steps are judged by
    the counters, which the compared epoch's numbers do not read."""
    def wrap(make):
        def made(*args, **kwargs):
            real = make(*args, **kwargs)

            def step(state, measure, *rest):
                out = real(state, measure, *rest)
                getattr(out[1], counter).add_(1)
                return out
            return step
        return made
    for name in ("make_step_fn", "make_pairs_step_fn"):
        monkeypatch.setattr(engine, name, wrap(getattr(engine, name)))
    out = _run(small_bench, cell)
    assert out["correct"] is False
    assert out["failed"] > 0
    drop = out["checked"]["dropped_per_million"]
    assert drop["value"] > drop["limit"]
