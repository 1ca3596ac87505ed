"""Per-particle stage (``Workload.advance``), the plain pass: the share of
its roofline -- the least time of the pass's job on the traced state
(``counts/walls.py``: K8's in-place job with no energized lanes, the wall
cases' lanes from one step of the specular pore's reference walls) over
the device time launched inside the program's ``amc/step/walls`` span a
call, in the program's own traced slice (``program_spans``).  None where
the span never ran: a program without it, or a cell whose pass is K8."""

import program_spans
from counts import walls

LAYER = "Per-particle stage (Workload.advance)"
UNIT = "%"
MOVES = "particle_steps_per_s"
SPANS = ()
KERNELS = ()
SPAN = "amc/step/walls"


def read(t):
    s = program_spans.of(t)
    calls = s.traced.calls.get(SPAN, 0) if s else 0
    seconds = s.traced.device_s(span=SPAN) if calls else 0.0
    if seconds <= 0.0:
        return None
    ms, _ = walls.bound_ms(t.state, t.setup)
    return 100.0 * ms / (seconds * 1e3 / calls)
