"""The port's spans (``argon_monte_carlo_tpu_torch.trace``) on the CPU: none
is recorded without a profiler; under ``torch.profiler`` one ``amc/grid`` a
grid built, one ``amc/step`` a step, one ``amc/rebuild`` a pair-list
window, the stages inside their step and the steps inside their epoch; and
a profiled run is bitwise the run without one.  The temperature pore in
pairs and sweep mode, and the cube, at sizes a CPU holds."""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import argon_monte_carlo_tpu_torch as amt
from argon_monte_carlo_tpu_torch import kernels, trace

STEPS, PER_EPOCH, K = 12, 6, 8
# "walls": the plain per-particle pass inside "advance" (on the CPU, K8's
# twin and the cube's planes both run it).
STAGES = {
    "pairs": {"advance", "walls", "resolve", "recapture", "dirty",
              "research", "flush", "counters"},
    "sweep": {"advance", "walls", "search", "resolve", "recapture", "flush",
              "counters"},
}
STAGES["cube"] = STAGES["sweep"]


def simulation(kind: str) -> amt.Simulation:
    if kind == "cube":
        cfg = amt.CubeConfig(num_particles_override=1000,
                             engine=amt.EngineConfig(
                                 broadphase="allpairs",
                                 steps_per_epoch=PER_EPOCH))
    else:
        eng = (amt.EngineConfig(narrowphase="pairs", rebuild_interval=K,
                                steps_per_epoch=PER_EPOCH)
               if kind == "pairs" else
               amt.EngineConfig(steps_per_epoch=PER_EPOCH))
        cfg = amt.temperature_pore_config(engine=eng).scaled_to(3000)
    return amt.Simulation(amt.make_workload(cfg), device="cpu")


def run(kind: str):
    sim = simulation(kind)
    state, measure, gen = sim.init(11)
    return sim.run(num_steps=STEPS, state=state, measure=measure,
                   generator=gen)


def tensors(out):
    state, measure, metrics = out
    return {f"{type(obj).__name__}.{f.name}": getattr(obj, f.name)
            for obj in (state, measure, metrics)
            for f in dataclasses.fields(obj)}


def test_off_is_one_shared_object():
    assert not trace.profiling()
    assert trace.span("amc/step") is trace.OFF
    assert trace.span("amc/epoch") is trace.OFF
    with trace.OFF as entered:
        assert entered is None


def recorder(monkeypatch) -> list:
    """The names ``trace.record`` is called with."""
    names = []

    def recording(name, *args):
        names.append(name)
        return trace.OFF

    monkeypatch.setattr(trace, "record", recording)
    return names


@pytest.mark.parametrize("kind", sorted(STAGES))
def test_no_span_without_a_profiler(monkeypatch, kind):
    names = recorder(monkeypatch)
    run(kind)
    assert names == []


def test_a_kernel_launch_is_a_span_only_under_the_profiler(monkeypatch):
    calls = []
    monkeypatch.setattr(kernels, "_launch",
                        lambda name, device, args: calls.append(name))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        kernels.launch("compact", torch.device("cpu"), 1, 2)
    names = recorder(monkeypatch)
    kernels.launch("compact", torch.device("cpu"), 1, 2)
    assert calls == ["compact", "compact"] and names == []
    assert [e.name for e in prof.events()
            if e.name.startswith("amc/")] == ["amc/launch"]


def test_a_span_is_a_host_event_and_no_user_annotation():
    """The profiler draws a user annotation (``record_function``) as a range
    on the device's timeline too; a span is recorded in the scope of an
    ``aten::`` op, which it does not draw there."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("amc/step"):
            torch.ones(3).add_(1.0)
        with torch.profiler.record_function("user"):
            pass
    scope = {e.name: e.scope for e in prof.events()}
    function = int(torch._C._profiler.RecordScope.FUNCTION)
    assert scope["amc/step"] == scope["aten::add_"] == function
    assert scope["user"] == int(torch._C._profiler.RecordScope.USER_SCOPE)


@pytest.mark.parametrize("kind", sorted(STAGES))
def test_spans_under_the_profiler(kind):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.profiling()
        traced = run(kind)
    assert not trace.profiling()
    spans = {}
    for e in prof.events():
        if e.name.startswith("amc/"):
            spans.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))

    def inside(name, outer):
        return all(any(a <= s and t <= b for a, b in spans[outer])
                   for s, t in spans[name])

    stages = {f"amc/step/{s}" for s in STAGES[kind]}
    rebuilds = -(-STEPS // K) if kind == "pairs" else 0
    # The Simulation is made under the profiler: one grid build, where the
    # broad phase has a grid (the pores; the cube runs all pairs).
    grids = 0 if kind == "cube" else 1
    assert {n: len(v) for n, v in spans.items()} == {
        "amc/epoch": STEPS // PER_EPOCH, "amc/step": STEPS,
        **{s: STEPS for s in stages},
        **({"amc/rebuild": rebuilds} if rebuilds else {}),
        **({"amc/grid": grids} if grids else {})}
    if grids:
        assert not any(a <= s and t <= b for s, t in spans["amc/grid"]
                       for a, b in spans["amc/epoch"])
    assert inside("amc/step", "amc/epoch")
    for s in stages:
        assert inside(s, "amc/step"), s
    assert inside("amc/step/walls", "amc/step/advance")
    if rebuilds:
        assert inside("amc/rebuild", "amc/epoch")
        assert not any(a <= s and t <= b for s, t in spans["amc/rebuild"]
                       for a, b in spans["amc/step"])

    plain = tensors(run(kind))
    for name, t in tensors(traced).items():
        assert (t is None and plain[name] is None) or torch.equal(
            t, plain[name]), name


@pytest.mark.cuda
def test_on_the_card_a_span_is_no_device_event():
    """A profiled pairs epoch on the card: the spans are host events (each
    hand-written kernel's call an ``amc/launch``) and none is on the
    device's timeline, where it would read as device work."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    eng = amt.EngineConfig(narrowphase="pairs", rebuild_interval=K,
                           steps_per_epoch=PER_EPOCH)
    cfg = amt.temperature_pore_config(engine=eng).scaled_to(20_000)
    sim = amt.Simulation(amt.make_workload(cfg), device="cuda")
    state, measure, gen = sim.init(11)
    sim.run(num_steps=PER_EPOCH, state=state, measure=measure, generator=gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sim.run(num_steps=PER_EPOCH, state=state, measure=measure,
                generator=gen)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    on_card = [e.name for e in prof.events() if e.device_type == cuda]
    host = [e.name for e in prof.events() if e.device_type != cuda]
    assert on_card and not any(n.startswith("amc/") for n in on_card)
    assert host.count("amc/step") == PER_EPOCH and "amc/launch" in host
