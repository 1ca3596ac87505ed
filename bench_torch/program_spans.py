"""The program's own spans (``amc/...``, which the port records whenever a
torch profiler records: ``argon_monte_carlo_tpu_torch/trace.py``) for the
per-layer metrics that read them.

The traced slice of ``harness.py`` hands its readers the device events of
the benchmark's wrapped spans alone, and no host event.  So the readers of
the program's spans read a slice of their own: after the harness's, from
the state it left, as many whole epochs of the window's loop
(``Simulation.run`` + ``io.metrics.epoch_to_host``), recorded with the
benchmark's wrappers off, and reduced by ``profiling.reduce`` with every
``amc/`` name in the trace as a span.  One slice a run, shared by every
reader.  A program that records no span leaves its readers nothing to
read.
"""

from __future__ import annotations

import dataclasses
import sys
import time
import weakref

import torch
from torch.profiler import ProfilerActivity, profile

import profiling as tr

PREFIX = "amc/"


@dataclasses.dataclass
class Slice:
    """The slice's device events with the ``amc/`` spans that launched
    them (``traced``: a ``profiling.Traced`` of this slice) and the main
    thread's host events (start, end, name; microseconds on the profiler's
    clock, launch calls left out)."""

    traced: tr.Traced
    host: list

    @property
    def steps(self) -> int:
        return self.traced.steps

    def spans(self, name: str) -> list:
        """(start, end) of each host event named ``name``, in us."""
        return [(a, b) for a, b, n in self.host if n == name]

    def top_host_ops(self, inside: str) -> int:
        """``aten::`` host ops that start inside an ``inside`` span and lie
        in no other ``aten::`` op (the profiler's nesting: a child starts
        no earlier than its parent and ends no later)."""
        within = tr._Intervals(self.spans(inside))
        n, end = 0, -float("inf")
        for a, b, name in sorted(self.host, key=lambda h: (h[0], -h[1])):
            if not name.startswith("aten::") or (a < end and b <= end):
                continue
            end = b
            n += within.contains(a)
        return n


def reduce(prof, t) -> Slice | None:
    """The slice of ``prof``, a trace of ``t.steps`` steps; None where it
    holds no ``amc/`` span."""
    names = {e.name for e in prof.events() if e.name.startswith(PREFIX)}
    if not names:
        return None
    red = tr.reduce(prof, names)
    traced = tr.Traced(
        events=red["events"], calls=red["calls"], steps=t.steps,
        busy_s=red["busy_s"], window_s=t.window_s,
        untraced_step_s=t.untraced_step_s, state=None, sim=None, setup=None,
        traffic=t.traffic, seed=t.seed)
    return Slice(traced, red["host"])


def record(t):
    """A profiler's trace of ``t.steps`` more steps of ``t.sim`` from
    ``t.state``, the window's loop with fresh accumulators and the run's
    seed, and the seconds it took."""
    from argon_monte_carlo_tpu_torch.io import metrics as metrics_io
    from argon_monte_carlo_tpu_torch.state import Measurements

    sim, state = t.sim, t.state
    device = state.pos.device
    on_card = device.type == "cuda"
    eng = sim.cfg.engine
    spe = t.traffic["steps_per_epoch"]
    measure = Measurements.zeros(eng.num_bins, eng.torch_dtype,
                                 num_particles=state.num_particles,
                                 device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(t.seed)
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    if on_card:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        start = time.perf_counter()
        for _ in range(t.steps // spe):
            state, measure, metrics = sim.run(
                num_steps=spe, state=state, measure=measure, generator=gen)
            metrics_io.epoch_to_host(metrics)
        if on_card:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - start
    return prof, seconds


# The last traced slice read (a weak reference: the run's objects are freed
# before the reference runs) and its own slice, which holds none of them.
_last: list = [lambda: None, None]


def of(t) -> Slice | None:
    """The program's spans in a slice of their own after the traced slice
    ``t`` (recorded on the first call for ``t``)."""
    if _last[0]() is not t:
        prof, seconds = record(t)
        s = reduce(prof, dataclasses.replace(t, window_s=seconds))
        del prof
        print(f"program's spans: {t.steps} steps in {seconds!r} s, span "
              f"calls {s.traced.calls if s else {}}", file=sys.stderr)
        _last[:] = [weakref.ref(t), s]
    return _last[1]
