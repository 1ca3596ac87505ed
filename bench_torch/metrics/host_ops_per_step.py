"""Driver (``engine.Simulation.run``, the step): the host ops (``aten::``,
each not nested in another) that start inside the program's ``amc/epoch``
spans, over the steps of the program's own traced slice
(``program_spans``) -- the host's twin of ``device_ops_per_step``, which
also counts the ops that launch nothing (allocations, views, ``stack``)."""

import program_spans

LAYER = "Driver (engine.Simulation.run, the step)"
UNIT = "ops/step"
MOVES = "particle_steps_per_s"
SPANS = ()
KERNELS = ()


def read(t):
    s = program_spans.of(t)
    n = s.top_host_ops(inside="amc/epoch") if s else 0
    return n / s.steps if n else None
