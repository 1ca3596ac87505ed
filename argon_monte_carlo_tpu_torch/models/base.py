"""Shared wall-case helpers for the workload models (port of
``models/base``): the missed-case audit and the free-path bookkeeping of
a wall case."""

from __future__ import annotations

import torch

from ..ops import fp
from ..ops import measure as measure_ops
from ..ops.walls import WallEvent
from ..state import Measurements, ParticleState

# The audit's cases, in the order of its counts.
AUDIT_CASES = ("1", "2a", "2b", "3a", "3b", "4", "5a", "5b", "6a", "6b")


def pore_missed_case_audit(state: ParticleState, prior: torch.Tensor, geom,
                           physics, energized: bool) -> torch.Tensor:
    """Re-evaluate each wall-case predicate after the wall pass; a residual
    count means a case was missed (models/base.py:12-62; the reference's
    audit prints, Open_Air_Pore_MC.py:488-511, Temperature_Pore_MC.py:
    760-802).  ``prior`` is the positions before the drift.

    Returns (10,) int32 in the order of AUDIT_CASES: the energized pore's
    predicates (with the argon-radius insets) or the specular pore v1's
    (with square roots).
    """
    ar = physics.argon_radius
    h = geom.total_height
    oah = geom.open_air_height
    gap_lo, gap_hi = geom.gap_bottom, geom.gap_top
    cr_gap = geom.gap_collision_radius(physics)
    cr_pore = geom.pore_collision_radius(physics)
    x, y, z = state.pos[:, 0], state.pos[:, 1], state.pos[:, 2]
    px, py, pz = prior[:, 0], prior[:, 1], prior[:, 2]
    r2 = x * x + y * y
    pr2 = px * px + py * py
    if energized:  # the insets of Temperature_Pore_MC.py's predicates
        c3a = (pz >= h - oah + ar) & (z < h - oah + ar) & (
            r2 > geom.pore_coated_radius**2)
        c3b = (pz <= oah - ar) & (z > oah - ar) & (
            r2 > geom.pore_coated_radius**2)
        c4 = ((pz < gap_hi - ar) & (pz > gap_lo + ar)
              & (pr2 <= cr_gap**2) & (r2 > cr_gap**2))
        in_gap = (pz <= gap_hi - ar) & (pz >= gap_lo + ar)
        c5a = (pr2 >= cr_pore**2) & (z < gap_lo + ar) & in_gap
        c5b = (pr2 >= cr_pore**2) & (z > gap_hi - ar) & in_gap
        crossed = (pr2 <= cr_pore**2) & (r2 > cr_pore**2)
        c6a = crossed & (z <= gap_lo + ar) & (z >= oah - ar)
        c6b = crossed & (z < h - oah + ar) & (z > gap_hi - ar)
    else:  # pore v1 (Open_Air_Pore_MC.py:488-511)
        r = fp.sqrt(r2)
        pr = fp.sqrt(pr2)
        c3a = (pz > h - oah) & (z < h - oah) & (r > geom.pore_coated_radius)
        c3b = (pz < oah) & (z > oah) & (r > geom.pore_coated_radius)
        c4 = ((pz < gap_hi) & (pz > gap_lo)
              & (pr < geom.gap_radius) & (r > geom.gap_radius))
        in_gap = (pz < gap_hi) & (pz > gap_lo)
        c5a = (pr > geom.pore_coated_radius) & (z < gap_lo) & in_gap
        c5b = (pr > geom.pore_coated_radius) & (z > gap_hi) & in_gap
        crossed = (pr < geom.pore_coated_radius) & (
            r > geom.pore_coated_radius)
        c6a = crossed & (z < h - oah) & (z > gap_hi)
        c6b = crossed & (z < gap_lo) & (z > oah)
    cases = [r2 > geom.open_air_radius**2, z < 0.0, z > h,
             c3a, c3b, c4, c5a, c5b, c6a, c6b]
    return torch.stack([torch.sum(c, dtype=torch.int32) for c in cases])


def apply_tracked(state: ParticleState, measure: Measurements,
                  event: WallEvent, case_mask: torch.Tensor,
                  paths_before: torch.Tensor, has_before: torch.Tensor,
                  zero_residual: bool):
    """Free-path bookkeeping and hit counting for one wall case.

    ``case_mask`` is the raw case predicate (every particle in the case,
    solver errors included, counts as a hit, Open_Air_Pore_MC.py:348);
    ``event.mask`` is the subset actually handled.
    Returns (state, measure, wall_hits).
    """
    measure = measure_ops.record_completed(
        measure, paths_before, has_before, event.vel_before, event.t,
        event.mask,
    )
    state = measure_ops.end_paths(state, event.mask, event.t, state.vel,
                                  zero_residual)
    return state, measure, torch.sum(case_mask, dtype=torch.int32)
