"""Driver (``engine.Simulation.run``, the step): the device memory that the
pairs step's CUDA-graph replay holds, in GiB: ``Simulation.graph_held_bytes``
(``StepGraphs.held_bytes``, a host int set after the captures: the graphs'
inputs -- the carried state, measurements and pair list, the uniforms, the
metrics' rows -- and the segments of the graphs' pool).  A program without
the counter, or a run that made no graphs, gives nothing."""

LAYER = "Driver (engine.Simulation.run, the step)"
UNIT = "GiB"
MOVES = "peak_mem_gib"
SPANS = ()
KERNELS = ()


def read(t):
    held = getattr(t.sim, "graph_held_bytes", None)
    return None if held is None else held / float(2**30)
