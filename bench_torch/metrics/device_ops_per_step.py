"""Driver (``engine.Simulation.run`` and the step functions): the device
operations the host enqueues a step, every kernel, copy and fill the
profiler saw in the traced slice (the steps and each epoch's copy to the
host), over its steps.  A CUDA graph of the
epoch or a kernel in place of glue cuts it."""

LAYER = "Driver (engine.Simulation.run, the step)"
UNIT = "ops/step"
MOVES = "particle_steps_per_s"
SPANS = ("Simulation.run",)
KERNELS = ()


def read(t):
    return len(t.events) / t.steps if t.events else None
