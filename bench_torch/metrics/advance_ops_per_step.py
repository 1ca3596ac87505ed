"""Per-particle stage (``Workload.advance``): the device operations
launched inside it a step -- K8 and its outputs' fills in the pores, the
plain specular planes in the cube."""

LAYER = "Per-particle stage (Workload.advance)"
UNIT = "ops/step"
MOVES = "particle_steps_per_s"
SPANS = ("Workload.advance",)
KERNELS = ()


def read(t):
    n = t.ops(span="Workload.advance")
    return n / t.steps if n else None
