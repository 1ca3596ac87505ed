"""Out-of-bounds audit and recapture for the pore (port of ``ops/oob.py``).

``pore_oob_count`` is audit-only (Temperature_Pore_MC.py:560-592);
``pore_recapture`` teleports escapees back inside
(Temperature_Pore_MC.py:594-616) and runs after the walls and after the
pair collisions; ``pore_v1_audit_nudge`` is the specular pore's combined
audit and nudge (Open_Air_Pore_MC.py:354-375) at the same two places.
"""

from __future__ import annotations

import dataclasses

import torch

from ..geometry import PoreGeometry
from ..physics import GasPhysics
from ..state import ParticleState


def _count(mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(mask, dtype=torch.int32)


def pore_oob_count(state: ParticleState, geom: PoreGeometry) -> torch.Tensor:
    """Audit-only count of particles outside the pore (0-d int32)."""
    x, y, z = state.pos[:, 0], state.pos[:, 1], state.pos[:, 2]
    x2y2 = x * x + y * y
    h = geom.total_height
    oah = geom.open_air_height
    return (
        _count(z < 0.0)
        + _count(z > h)
        + _count((x2y2 > geom.open_air_radius**2) & (z >= 0.0) & (z <= oah))
        + _count((x2y2 > geom.open_air_radius**2) & (z >= h - oah) & (z <= h))
        + _count((x2y2 > geom.gap_radius**2) & (z >= geom.gap_bottom)
                 & (z <= geom.gap_top))
        + _count((x2y2 > geom.pore_coated_radius**2) & (z > oah)
                 & (z < geom.gap_bottom))
        + _count((x2y2 > geom.pore_coated_radius**2) & (z > geom.gap_top)
                 & (z < h - oah))
    )


def pore_recapture(state: ParticleState, geom: PoreGeometry,
                   z_inset: float = 50e-9):
    """Teleport escapees inside: z first, then the radial checks on the
    updated z (reference order).  Returns (state, num_recaptured)."""
    x, y, z = state.pos[:, 0], state.pos[:, 1], state.pos[:, 2]
    h = geom.total_height
    zero = torch.zeros_like(x)

    m1 = z < 0.0
    z = torch.where(m1, torch.full_like(z, z_inset), z)
    m2 = z > h
    z = torch.where(m2, torch.full_like(z, h - z_inset), z)

    m3 = x * x + y * y > geom.open_air_radius**2
    x = torch.where(m3, zero, x)
    y = torch.where(m3, zero, y)

    inside = (z > geom.open_air_height) & (z < h - geom.open_air_height)
    m4 = (x * x + y * y > geom.gap_radius**2) & inside
    x = torch.where(m4, zero, x)
    y = torch.where(m4, zero, y)

    in_coated = ((z > geom.open_air_height) & (z < geom.gap_bottom)) | (
        (z > geom.gap_top) & (z < h - geom.open_air_height)
    )
    m5 = (x * x + y * y > geom.pore_coated_radius**2) & in_coated
    x = torch.where(m5, zero, x)
    y = torch.where(m5, zero, y)

    count = _count(m1) + _count(m2) + _count(m3) + _count(m4) + _count(m5)
    return (dataclasses.replace(state, pos=torch.stack([x, y, z], dim=-1)),
            count)


def pore_v1_audit_nudge(state: ParticleState, geom: PoreGeometry,
                        physics: GasPhysics):
    """The specular pore's combined audit and nudge
    (Open_Air_Pore_MC.py:354-375): a z stray moves back by 10 argon radii,
    a radial stray snaps to the axis, each radial check on the updated
    coordinates.  Returns (state, count)."""
    ar = physics.argon_radius
    x, y, z = state.pos[:, 0], state.pos[:, 1], state.pos[:, 2]
    h = geom.total_height
    zero = torch.zeros_like(x)

    m1 = z < 0.0
    z = torch.where(m1, z + 10.0 * ar, z)
    m2 = z > h
    z = torch.where(m2, z - 10.0 * ar, z)

    m3 = x * x + y * y > geom.open_air_radius**2
    x = torch.where(m3, zero, x)
    y = torch.where(m3, zero, y)

    inside = (z > geom.open_air_height) & (z < h - geom.open_air_height)
    m4 = (x * x + y * y > geom.gap_radius**2) & inside
    x = torch.where(m4, zero, x)
    y = torch.where(m4, zero, y)

    in_coated = ((z > geom.open_air_height) & (z < geom.gap_bottom)) | (
        (z > geom.gap_top) & (z < h - geom.open_air_height)
    )
    m5 = (x * x + y * y > geom.pore_coated_radius**2) & in_coated
    x = torch.where(m5, zero, x)
    y = torch.where(m5, zero, y)

    count = _count(m1) + _count(m2) + _count(m3) + _count(m4) + _count(m5)
    return (dataclasses.replace(state, pos=torch.stack([x, y, z], dim=-1)),
            count)
