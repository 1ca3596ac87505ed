"""Per-particle stage (``Workload.advance``, K8): K8's share of its bound
in place (``counts/k8.py``) over its device time a call in the traced
slice.  The wall-case lanes that the bytes count are those of one step of
the reference's walls (``reference/walls.pore_walls``) from the traced
slice's state, with uniforms drawn from the run's seed."""

import torch

from counts import k8
from reference import walls as W

LAYER = "Per-particle stage (Workload.advance)"
UNIT = "%"
MOVES = "particle_steps_per_s"
SPANS = ("Workload.advance",)
KERNELS = ("pore_advance_kernel", "ledger_totals_kernel")


def wall_cases(state, setup, seed: int) -> tuple:
    """(lanes of all six wall cases, lanes of the thermal cases 3-6)."""
    gen = torch.Generator(device=state.pos.device)
    gen.manual_seed(seed)
    u = torch.rand((state.pos.shape[0], 2), generator=gen,
                   device=state.pos.device)
    S = dict(pos=state.pos + setup.dt * state.vel, vel=state.vel,
             paths=state.paths, has_collided=state.has_collided,
             vals=torch.zeros_like(state.paths),
             staged=torch.zeros_like(state.has_collided))
    cases = {}
    W.pore_walls(S, state.pos, u, setup, cases)
    hits = sum(int(m.sum()) for m in cases.values())
    energized = sum(int(m.sum()) for k, m in cases.items()
                    if k[0] in "3456")
    return hits, energized


def read(t):
    calls = t.calls.get("Workload.advance", 0)
    s = t.device_s(span="Workload.advance", kernels=KERNELS)
    if not calls or s <= 0.0:
        return None
    hits, energized = wall_cases(t.state, t.setup, t.seed)
    ms, _ = k8.bound_ms(t.state.num_particles, hits, energized)
    return 100.0 * ms / (s * 1e3 / calls)
