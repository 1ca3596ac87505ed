"""Per-particle stage (``Workload.advance``), the plain pass: the device
time launched inside the program's ``amc/step/walls`` span (drift, the
workload's wall pass, the audit where it runs, the post-wall fix; the
specular pore's whole per-particle stage) over the steps of the program's
own traced slice (``program_spans``).  None where the span never ran: a
program without it, or a cell whose pass is K8."""

import program_spans

LAYER = "Per-particle stage (Workload.advance)"
UNIT = "ms/step"
MOVES = "particle_steps_per_s"
SPANS = ()
KERNELS = ()
SPAN = "amc/step/walls"


def read(t):
    s = program_spans.of(t)
    seconds = s.traced.device_s(span=SPAN) if s else 0.0
    return seconds * 1e3 / s.steps if seconds > 0.0 else None
