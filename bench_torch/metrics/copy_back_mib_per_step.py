"""Driver (``engine.Simulation.run``, the step): the MiB that a replayed
pairs step copies back into the CUDA graphs' fixed inputs, the mean over a
rebuild window: ``Simulation.copy_back_bytes_per_step`` (host numbers set
when each graph's body runs: the tensors the step made anew, where an
in-place kernel would need no copy).  A program without the counter, or a
run that made no graphs, gives nothing."""

LAYER = "Driver (engine.Simulation.run, the step)"
UNIT = "MiB/step"
MOVES = "particle_steps_per_s"
SPANS = ()
KERNELS = ()


def read(t):
    copied = getattr(t.sim, "copy_back_bytes_per_step", None)
    return None if copied is None else copied / float(2**20)
