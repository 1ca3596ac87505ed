"""Sweep step kernels (``ops.collide.partner_sweep``): K9's share of its
bound -- the pair tests the finest cell grid for the collision range
needs on the traced slice's state (``counts/k9.py``) -- over its device
time a call."""

from counts import k9

LAYER = "Sweep step kernels (ops.collide.partner_sweep)"
UNIT = "%"
MOVES = "particle_steps_per_s"
SPANS = ("ops.collide.partner_sweep",)
KERNELS = ("partner_init_kernel", "partner_walk_kernel")


def read(t):
    calls = t.calls.get("ops.collide.partner_sweep", 0)
    s = t.device_s(span="ops.collide.partner_sweep", kernels=KERNELS)
    if not calls or s <= 0.0:
        return None
    ms, _ = k9.bound_ms(t.state.pos, t.setup.cr)
    return 100.0 * ms / (s * 1e3 / calls)
