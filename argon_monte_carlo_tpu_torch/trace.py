"""The port's spans, in the trace of whatever ``torch.profiler`` records.

``span(name)`` is a record function of the profiler (``record``) while a
torch profiler is recording and one shared no-op context otherwise: the
spans turn on exactly when someone profiles the program, and cost one
check of the profiler's flag (a few hundred nanoseconds on a CPU) when no
one does.  They land in the profiler's own trace, on the clock of its CUDA
events, so every device op is tied to the span that launched it and every
idle gap of the card to the innermost span the host was in.

``record`` is the profiler's function-scope record function, the kind an
``aten::`` op records, and not ``torch.profiler.record_function``: that one
is a user annotation, which the profiler also draws as a range on the
device's timeline, where a reader of the trace would take it for device
work.  A span here is a host event alone.

Every name starts with ``amc/``:

- ``amc/epoch``: one epoch of ``Simulation.run`` (draws, rebuilds, steps,
  the stacking of its ``StepMetrics``);
- ``amc/rebuild``: ``Simulation.rebuild`` (K2, K1, K5);
- ``amc/step``: the body of a step function, and in it its stages
  ``amc/step/advance`` (and in it ``amc/step/walls``: the plain
  per-particle pass of ``engine.advance_plain`` after the speed -- drift
  and path accrual, the wall pass, the missed-case audit where it runs,
  the post-wall fix -- which the cube runs; the specular pore's pass,
  which on the card is K14's launch, recorded as the same span; K8
  replaces it for the temperature pore on the card and records none; on
  the CPU both kernels' twin is this pass, so it records the span there
  too), ``/search``
  (the sweep's and the cube's), ``/resolve``,
  ``/recapture``, ``/dirty``, ``/research`` (the pairs step's), ``/flush``
  and ``/counters`` (the pairs step's last four are
  ``engine.pairs_step_tail``'s, which the z-slab engine records too, a
  slab at a time, with no ``amc/step`` around them);
- ``amc/launch``: ``kernels.launch``, one hand-written kernel's call;
- ``amc/grid``: ``engine.build_grids``, the host's grid and its copy to
  the device (set-up);
- ``amc/capture``: a ``StepGraphs`` graph's eager step or its capture
  (set-up; a profiled run takes the loop and makes no graph, so only a
  profiler started inside a replayed run would see it).

A pairs run on the card replays its steps from CUDA graphs, which run no
Python and so record no span; while a profiler records it takes the loop
(``engine.replays_steps``), which records them all.
"""

from __future__ import annotations

import torch

# True while a torch profiler records (the autograd profiler's flag, which
# ``torch.profiler.profile`` sets).
profiling = torch._C._autograd._profiler_enabled


class _Off:
    """The span of a run that no profiler records: enters and leaves."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()

# A context that records its name as a host event of the running profiler.
record = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A ``with`` context that records ``name`` in the running profiler's
    trace, or ``OFF`` where none runs."""
    if profiling():
        return record(name)
    return OFF
