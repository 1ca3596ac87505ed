"""Pairs step (``engine.make_pairs_step_fn`` outside the rebuild and the
advance: K3, K6, K4, K7c and their glue): the device time launched inside
the step and outside ``Workload.advance``, over the traced steps (the
rebuild runs outside the step)."""

LAYER = "Pairs step (engine.make_pairs_step_fn)"
UNIT = "ms/step"
MOVES = "particle_steps_per_s"
SPANS = ("Simulation._step", "Workload.advance")
KERNELS = ()


def read(t):
    s = t.device_s(span="Simulation._step", outside="Workload.advance")
    return s * 1e3 / t.steps if s > 0.0 else None
