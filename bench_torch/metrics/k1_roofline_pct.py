"""Pairs rebuild: K1's share of its roofline -- the least time its bytes
need on the traced slice's state (``counts/k1.py``: the particles, and
the pairs within reach at the mix's rebuild interval) over its device
time a rebuild in the traced slice."""

from counts import k1

LAYER = "Pairs rebuild (ops.pairs.rebuild)"
UNIT = "%"
MOVES = "particle_steps_per_s"
SPANS = ("ops.pairs.rebuild",)
KERNELS = ("pack_and_fill_kernel", "rebuild_walk_kernel")


def read(t):
    calls = t.calls.get("ops.pairs.rebuild", 0)
    s = t.device_s(span="ops.pairs.rebuild", kernels=KERNELS)
    if not calls or s <= 0.0:
        return None
    ms, _ = k1.bound_ms(t.state.pos, t.state.vel, t.setup.cr, t.setup.dt,
                        t.traffic["rebuild_interval"])
    return 100.0 * ms / (s * 1e3 / calls)
