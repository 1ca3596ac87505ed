"""Driver (``engine.Simulation.run``, the step): the device ops launched
inside the program's ``amc/epoch`` spans and outside its ``amc/launch``
spans (the hand-written kernels), over the steps of the program's own
traced slice (``program_spans``) -- the plain PyTorch work that kernels
in place of glue would fold away."""

import program_spans

LAYER = "Driver (engine.Simulation.run, the step)"
UNIT = "ops/step"
MOVES = "particle_steps_per_s"
SPANS = ()
KERNELS = ()


def read(t):
    s = program_spans.of(t)
    n = s.traced.ops(span="amc/epoch", outside="amc/launch") if s else 0
    return n / s.steps if n else None
