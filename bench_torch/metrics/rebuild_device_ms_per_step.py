"""Pairs rebuild (``ops.pairs.rebuild``: K2, K1, K5 and their glue): the
device time launched inside the rebuild, over the traced steps."""

LAYER = "Pairs rebuild (ops.pairs.rebuild)"
UNIT = "ms/step"
MOVES = "particle_steps_per_s"
SPANS = ("ops.pairs.rebuild",)
KERNELS = ()


def read(t):
    s = t.device_s(span="ops.pairs.rebuild")
    return s * 1e3 / t.steps if s > 0.0 else None
