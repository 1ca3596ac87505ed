"""Cube broad phase (``ops.collide.allpairs_partner_search``): K11's
share of its bound -- positions read and partners written
(``counts/k11.py``) -- over its device time a call, its four launches."""

from counts import k11

LAYER = "Cube broad phase (ops.collide.allpairs_partner_search)"
UNIT = "%"
MOVES = "particle_steps_per_s"
SPANS = ("ops.collide.allpairs_partner_search",)
KERNELS = ("slab_count_kernel", "count_scan_kernel", "slab_scatter_kernel",
           "slab_search_kernel")


def read(t):
    calls = t.calls.get("ops.collide.allpairs_partner_search", 0)
    s = t.device_s(span="ops.collide.allpairs_partner_search",
                   kernels=KERNELS)
    if not calls or s <= 0.0:
        return None
    ms, _ = k11.bound_ms(t.state.pos, t.setup.cr)
    return 100.0 * ms / (s * 1e3 / calls)
