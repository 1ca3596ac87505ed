"""Random sampling: Maxwell velocities, uniform disks, spherical-cap cones.

Port of ``argon_monte_carlo_tpu.rng``.  Every draw comes from an explicit
``torch.Generator`` (Philox on the card), so a run is a function of its
seed but not bitwise equal to the JAX reference's threefry stream: the two
agree in distribution.  The cone helpers are pure functions of uniforms
that the caller draws, which lets a test feed both packages the same
numbers.
"""

from __future__ import annotations

import math

import torch

from .ops import fp


def maxwell_velocities(gen: torch.Generator, n: int, a_shape: float,
                       dtype=torch.float32, device="cpu") -> torch.Tensor:
    """(n, 3) velocities; |N(0, a^2 I_3)| is Maxwell(a), isotropic."""
    return a_shape * torch.randn((n, 3), generator=gen, dtype=dtype,
                                 device=device)


def uniform_disk(gen: torch.Generator, n: int, radius: float,
                 dtype=torch.float32, device="cpu"):
    """(n,) x and y uniform over a disk (r*sqrt(u) cos/sin theta,
    Open_Air_Pore_MC.py:106-121)."""
    u = torch.rand((n,), generator=gen, dtype=dtype, device=device)
    theta = (2.0 * math.pi) * torch.rand((n,), generator=gen, dtype=dtype,
                                         device=device)
    r = radius * fp.sqrt(u)
    return r * torch.cos(theta), r * torch.sin(theta)


def orthonormal_frame(n: torch.Tensor):
    """Branchless tangent frame (e1, e2) for unit normals (..., 3)
    (Duff et al., "Building an Orthonormal Basis, Revisited", 2017)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    one = torch.ones_like(nz)
    s = torch.where(nz >= 0.0, one, -one)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    e1 = torch.stack([1.0 + s * nx * nx * a, s * b, -s * nx], dim=-1)
    e2 = torch.stack([b, s + ny * ny * a, -ny], dim=-1)
    return e1, e2


def cone_trig(uniforms: torch.Tensor, cos_half_angle: float):
    """(cos_t, sin_t*cos(phi), sin_t*sin(phi)) from (..., 2) uniforms; one
    evaluation per step feeds every energized wall case."""
    u1 = uniforms[..., 0]
    u2 = uniforms[..., 1]
    cos_t = cos_half_angle + u1 * (1.0 - cos_half_angle)
    sin_t = fp.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = (2.0 * math.pi) * u2
    return cos_t, sin_t * torch.cos(phi), sin_t * torch.sin(phi)


def cone_from_trig(trig, axis: torch.Tensor) -> torch.Tensor:
    """Spherical-cap direction about arbitrary unit ``axis`` (..., 3)."""
    cos_t, a, b = trig
    e1, e2 = orthonormal_frame(axis)
    return cos_t[..., None] * axis + a[..., None] * e1 + b[..., None] * e2


def cone_from_trig_z(trig, sign: float) -> torch.Tensor:
    """Spherical-cap direction about (0, 0, sign) for the z-plane walls."""
    cos_t, a, b = trig
    return torch.stack([a, b, sign * cos_t], dim=-1)
