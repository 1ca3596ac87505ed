"""Boundary (wall) collisions as masked tensor transforms, no loops.

Port of ``argon_monte_carlo_tpu.ops.walls`` (plain tensor code in both
packages).  Each case is a dense, branch-free transform applied under its
mask, in the reference's operation order:

* specular plane (any axis)      -- Open_Air_Cube_MC.py:189-226
* specular cylinder side wall    -- Open_Air_Pore_MC.py:294-348
* energized (Debye) plane        -- Temperature_Pore_MC.py:349-412
* energized cylinder side wall   -- Temperature_Pore_MC.py:414-553

Energized walls re-emit in an 85-degree cone about the inward normal and
exchange energy with the surface: E' = E + (E_surf - E) * alpha.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from .. import rng
from . import fp
from ..state import ParticleState


def _safe(x: torch.Tensor) -> torch.Tensor:
    """Replace zeros so masked-out lanes never divide by zero."""
    return torch.where(x == 0.0, torch.ones_like(x), x)


@dataclasses.dataclass
class WallEvent:
    """Result of one wall case applied to the full particle set."""

    state: ParticleState
    mask: torch.Tensor        # which particles the case actually handled
    t: torch.Tensor           # (N,) back-trace time
    vel_before: torch.Tensor  # velocities prior to the case
    err_mask: torch.Tensor    # degenerate geometry (Open_Air_Pore_MC.py:336)
    momentum_z: torch.Tensor  # ledger contributions (0 if specular)
    energy: torch.Tensor


def _with_column(x: torch.Tensor, axis: int, col: torch.Tensor):
    cols = list(x.unbind(dim=1))
    cols[axis] = col
    return torch.stack(cols, dim=1)


def specular_plane(state: ParticleState, mask: torch.Tensor, axis: int,
                   plane: float) -> WallEvent:
    """t = (p - plane)/v ; v' = -v ; p' = plane + t v'
    (Open_Air_Cube_MC.py:192-195)."""
    p = state.pos[:, axis]
    v = state.vel[:, axis]
    t = (p - plane) / _safe(v)
    new_v = -v
    new_p = plane + t * new_v
    new_state = dataclasses.replace(
        state,
        pos=_with_column(state.pos, axis, torch.where(mask, new_p, p)),
        vel=_with_column(state.vel, axis, torch.where(mask, new_v, v)),
    )
    zero = torch.zeros((), dtype=state.pos.dtype, device=state.pos.device)
    return WallEvent(new_state, mask, t, state.vel, torch.zeros_like(mask),
                     zero, zero)


def _cylinder_backtrace(pos, vel, radius):
    """Smaller root of |p_xy - v_xy t|^2 = R^2; ok=False where the backward
    ray misses the circle (Open_Air_Pore_MC.py:310-338)."""
    x, y = pos[:, 0], pos[:, 1]
    vx, vy = vel[:, 0], vel[:, 1]
    a = vx * vx + vy * vy
    b = -2.0 * (x * vx + y * vy)
    c = x * x + y * y - radius * radius
    disc = b * b - 4.0 * a * c
    ok = (disc >= 0.0) & (a > 0.0)
    sq = fp.sqrt(torch.clamp(disc, min=0.0))
    t = (-b - sq) / (2.0 * _safe(a))
    return t, ok


def specular_cylinder(state: ParticleState, mask: torch.Tensor,
                      radius: float) -> WallEvent:
    """2D reflection off a cylinder side wall: back-trace, reflect (vx, vy)
    about the normal, replay (Open_Air_Pore_MC.py:294-348)."""
    t, ok = _cylinder_backtrace(state.pos, state.vel, radius)
    handled = mask & ok
    err = mask & ~ok
    x, y = state.pos[:, 0], state.pos[:, 1]
    vx, vy = state.vel[:, 0], state.vel[:, 1]
    col_x = x - vx * t
    col_y = y - vy * t
    nx_, ny_ = fp.div(col_x, radius), fp.div(col_y, radius)
    dot = vx * nx_ + vy * ny_
    new_vx = vx - 2.0 * dot * nx_
    new_vy = vy - 2.0 * dot * ny_
    new_x = col_x + new_vx * t
    new_y = col_y + new_vy * t
    pos = torch.stack([torch.where(handled, new_x, x),
                       torch.where(handled, new_y, y), state.pos[:, 2]], dim=1)
    vel = torch.stack([torch.where(handled, new_vx, vx),
                       torch.where(handled, new_vy, vy), state.vel[:, 2]],
                      dim=1)
    zero = torch.zeros((), dtype=state.pos.dtype, device=state.pos.device)
    return WallEvent(dataclasses.replace(state, pos=pos, vel=vel), handled,
                     t, state.vel, err, zero, zero)


def _thermal_exchange(vel, surface_energy, alpha, mass):
    """E' = E + (E_surf - E) alpha; returns (new_speed, delta_E)
    (Temperature_Pore_MC.py:377-385)."""
    speed2 = vel[:, 0] * vel[:, 0] + vel[:, 1] * vel[:, 1] + vel[:, 2] * vel[:, 2]
    energy = 0.5 * mass * speed2
    new_energy = energy + (surface_energy - energy) * alpha
    new_speed = fp.sqrt(torch.clamp(fp.div(new_energy * 2.0, mass), min=0.0))
    return new_speed, new_energy - energy


def energized_plane(state: ParticleState, mask: torch.Tensor, plane: float,
                    inbound_sign: float, surface_energy: float, alpha: float,
                    mass: float, cone_trig: tuple) -> WallEvent:
    """Thermal wall on a z-plane: placed AT the impact point (no replay),
    re-emitted in a cone about (0, 0, inbound_sign)
    (Temperature_Pore_MC.py:349-412)."""
    z = state.pos[:, 2]
    vz = state.vel[:, 2]
    t = (z - plane) / _safe(vz)
    col_x = state.pos[:, 0] - state.vel[:, 0] * t
    col_y = state.pos[:, 1] - state.vel[:, 1] * t
    direction = rng.cone_from_trig_z(cone_trig, inbound_sign)
    new_speed, d_energy = _thermal_exchange(state.vel, surface_energy, alpha,
                                            mass)
    new_vel = direction * new_speed[:, None]
    d_pz = mass * (new_vel[:, 2] - vz)
    mask_f = mask.to(state.pos.dtype)
    momentum_z = torch.sum(mask_f * d_pz)
    energy = torch.sum(mask_f * d_energy)
    new_pos = torch.stack([col_x, col_y, torch.full_like(col_x, plane)],
                          dim=-1)
    new_state = dataclasses.replace(
        state,
        pos=torch.where(mask[:, None], new_pos, state.pos),
        vel=torch.where(mask[:, None], new_vel, state.vel),
    )
    return WallEvent(new_state, mask, t, state.vel, torch.zeros_like(mask),
                     momentum_z, energy)


def energized_cylinder(state: ParticleState, mask: torch.Tensor,
                       radius: float,
                       surface_energy: Callable | float, alpha: float,
                       mass: float, cone_trig: tuple) -> WallEvent:
    """Thermal cylinder side wall (Temperature_Pore_MC.py:414-553);
    ``surface_energy`` is a constant or a callable of the impact z."""
    t, ok = _cylinder_backtrace(state.pos, state.vel, radius)
    handled = mask & ok
    err = mask & ~ok
    col = state.pos - state.vel * t[:, None]
    inward = torch.stack(
        [fp.div(-col[:, 0], radius), fp.div(-col[:, 1], radius),
         torch.zeros_like(t)],
        dim=-1,
    )
    direction = rng.cone_from_trig(cone_trig, inward)
    e_surf = (surface_energy(col[:, 2]) if callable(surface_energy)
              else surface_energy)
    new_speed, d_energy = _thermal_exchange(state.vel, e_surf, alpha, mass)
    new_vel = direction * new_speed[:, None]
    d_pz = mass * (new_vel[:, 2] - state.vel[:, 2])
    mask_f = handled.to(state.pos.dtype)
    momentum_z = torch.sum(mask_f * d_pz)
    energy = torch.sum(mask_f * d_energy)
    new_state = dataclasses.replace(
        state,
        pos=torch.where(handled[:, None], col, state.pos),
        vel=torch.where(handled[:, None], new_vel, state.vel),
    )
    return WallEvent(new_state, handled, t, state.vel, err, momentum_z,
                     energy)


@dataclasses.dataclass(frozen=True)
class GapEnergyPoly:
    """The gap's E_surf(z): a polynomial in t = 2 (z - z_lo) / (z_hi - z_lo)
    - 1, clamped to [-1, 1], evaluated by Horner from ``power`` (highest
    degree first).  K8 takes the same host doubles."""

    z_lo: float
    z_hi: float
    power: tuple

    def __call__(self, z: torch.Tensor) -> torch.Tensor:
        t = torch.clamp(
            fp.div(z - self.z_lo, self.z_hi - self.z_lo) * 2.0 - 1.0,
            -1.0, 1.0,
        )
        acc = torch.full_like(t, self.power[0])
        for c in self.power[1:]:
            acc = acc * t + c
        return acc


def gap_energy_interp(table_z_lo: float, table_z_hi: float,
                      energies) -> GapEnergyPoly:
    """Degree-12 Chebyshev fit of the gap's E_surf(z) samples, evaluated by
    Horner in the power basis (fit on the host, as in the reference)."""
    e = np.asarray(energies, np.float64)
    x = np.linspace(-1.0, 1.0, len(e))
    coeffs = np.polynomial.chebyshev.chebfit(x, e, deg=min(12, len(e) - 1))
    power = np.polynomial.chebyshev.cheb2poly(coeffs)[::-1]  # high->low
    return GapEnergyPoly(float(table_z_lo), float(table_z_hi),
                         tuple(float(c) for c in power))


def cos_cone_from_deg(half_angle_deg: float) -> float:
    return math.cos(math.radians(half_angle_deg))
