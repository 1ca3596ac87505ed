"""The specular pore's per-particle pass (the span ``amc/step/walls``:
drift and path accrual, the six specular wall cases, the audit and nudge)
by its job alone, whatever implements it: the job K8 does in place for the
energized pore (``counts/k8.py``) with no energized lanes -- pos, vel,
paths and has_collided read, pos and paths written, the nudge's recapture
mask and the speed written (74 bytes a particle), and each wall case's
lane its vel, has_collided and staging row (30 bytes).  The lanes are
those that one step of the reference's walls
(``reference/specular_pore.walls``) takes from the traced state; a lane
that two cases take counts twice.  The plain pass's own temporaries (its
~100 N-wide intermediate arrays) do not enter."""

from __future__ import annotations

import torch

from reference import specular_pore

from . import k8


def wall_lanes(state, setup) -> int:
    """The lanes of all six wall cases in one step of the reference's
    walls from ``state`` (pos, vel, paths, has_collided)."""
    S = dict(pos=state.pos + setup.dt * state.vel, vel=state.vel,
             paths=state.paths, has_collided=state.has_collided,
             vals=torch.zeros_like(state.paths),
             staged=torch.zeros_like(state.has_collided))
    cases = {}
    specular_pore.walls(S, state.pos, None, setup, cases)
    return sum(int(m.sum()) for m in cases.values())


def bytes_moved(n: int, hits: int) -> int:
    return k8.bytes_in_place(n, hits, 0)


def bound_ms(state, setup) -> tuple:
    """(least ms, what bounds it) of one step's pass on ``state``."""
    return k8.bound_ms(state.pos.shape[0], wall_lanes(state, setup), 0)
