"""Driver (``engine.Simulation.run``, the step): the share of the run's
steps that ``Simulation.run`` replayed from CUDA graphs, of every step it
took: ``100 * replayed / (replayed + looped)`` from the ``Simulation``'s
own counters (``replayed_steps``, ``looped_steps``; host ints that cost no
read of the card).  The loop's steps are those of the traced slices and
each graph's first, eager step.  A program without the counters gives
nothing."""

LAYER = "Driver (engine.Simulation.run, the step)"
UNIT = "%"
MOVES = "particle_steps_per_s"
SPANS = ()
KERNELS = ()


def read(t):
    replayed = getattr(t.sim, "replayed_steps", None)
    looped = getattr(t.sim, "looped_steps", None)
    if replayed is None or looped is None or replayed + looped == 0:
        return None
    return 100.0 * replayed / (replayed + looped)
