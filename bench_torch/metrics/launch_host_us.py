"""Kernel wrappers (``kernels.launch``): the mean host time of one of the
program's ``amc/launch`` spans -- the library's lookup, the device made
current, the stream looked up, the call and its error check -- in the
program's own traced slice (``program_spans``), on the profiler's
clock."""

import program_spans

LAYER = "Kernel wrappers (kernels.launch)"
UNIT = "us/launch"
MOVES = "particle_steps_per_s"
SPANS = ()
KERNELS = ()


def read(t):
    s = program_spans.of(t)
    spans = s.spans("amc/launch") if s else []
    return sum(b - a for a, b in spans) / len(spans) if spans else None
