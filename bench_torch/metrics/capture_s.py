"""Driver (``engine.Simulation.run``, the step): the host seconds of set-up
that the pairs step's CUDA-graph replay costs: ``Simulation.capture_s``
(``StepGraphs.capture_s``: each graph's eager step on the capture stream
and its capture, summed; a host float).  A program without the counter, or
a run that made no graphs, gives nothing."""

LAYER = "Driver (engine.Simulation.run, the step)"
UNIT = "s"
MOVES = "setup_s"
SPANS = ()
KERNELS = ()


def read(t):
    return getattr(t.sim, "capture_s", None)
