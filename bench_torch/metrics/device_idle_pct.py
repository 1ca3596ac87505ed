"""Device (H100): the share of the untraced step time in which the card
runs nothing, 1 - device busy time a traced step / untraced step time of
the same process (``chip_smoke.breakdown``'s idle share).  In a host-bound
cell it is the rate lost to the host."""

LAYER = "Device (H100)"
UNIT = "%"
MOVES = "particle_steps_per_s"
SPANS = ()
KERNELS = ()


def read(t):
    if t.steps == 0 or not t.events:
        return None
    return 100.0 * (1.0 - (t.busy_s / t.steps) / t.untraced_step_s)
