"""Pairs step (``engine.make_pairs_step_fn``, K13): K13's share of its
roofline -- the least time the job's bytes need on the traced state
(``counts/k13.py``) over its device time a step in the traced slice.
None where the kernel never ran: a program without K13, or a cell whose
steps do not run it."""

from counts import k13

LAYER = "Pairs step (engine.make_pairs_step_fn)"
UNIT = "%"
MOVES = "particle_steps_per_s"
SPANS = ("Simulation._step",)
KERNELS = ("post_pairs_kernel",)


def read(t):
    calls = t.calls.get("Simulation._step", 0)
    s = t.device_s(span="Simulation._step", kernels=KERNELS)
    if not calls or s <= 0.0:
        return None
    ms, _ = k13.bound_ms(t.state.num_particles)
    return 100.0 * ms / (s * 1e3 / calls)
