"""Driver (``engine.Simulation.run``, the step): the host's time inside
the program's ``amc/epoch`` spans (draws, rebuilds, steps, the stacking
of the epoch's metrics) over the steps of the program's own traced slice
(``program_spans``) -- the time to enqueue a step, on the profiler's
clock (which slows the host it times)."""

import program_spans

LAYER = "Driver (engine.Simulation.run, the step)"
UNIT = "ms/step"
MOVES = "particle_steps_per_s"
SPANS = ()
KERNELS = ()


def read(t):
    s = program_spans.of(t)
    us = sum(b - a for a, b in s.spans("amc/epoch")) if s else 0.0
    return us * 1e-3 / s.steps if us > 0.0 else None
