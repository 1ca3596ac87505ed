"""Per-particle stage (``Workload.advance``), the plain pass: the device
ops launched inside the program's ``amc/step/walls`` span over the steps
of the program's own traced slice (``program_spans``) -- the count that a
fused pass folds to one or two.  None where the span never ran: a program
without it, or a cell whose pass is K8."""

import program_spans

LAYER = "Per-particle stage (Workload.advance)"
UNIT = "ops/step"
MOVES = "particle_steps_per_s"
SPANS = ()
KERNELS = ()
SPAN = "amc/step/walls"


def read(t):
    s = program_spans.of(t)
    n = s.traced.ops(span=SPAN) if s else 0
    return n / s.steps if n else None
