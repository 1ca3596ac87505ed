"""Set-up (``engine.build_grids``): the host seconds of the collision grid's
build, the host's grid and its copy to the card: ``Simulation.grid_build_s``
(a host float).  A program without the counter, or a run without a grid
(the all-pairs broad phase), gives nothing."""

LAYER = "Set-up (engine.build_grids)"
UNIT = "s"
MOVES = "setup_s"
SPANS = ()
KERNELS = ()


def read(t):
    return getattr(t.sim, "grid_build_s", None)
