"""Vectorized particle initialization (port of ``init.init_cube`` and
``init.init_pore``).

Same segment counts, radii, z ranges and stratification as the reference
(Open_Air_Cube_MC.py:144-156, Open_Air_Pore_MC.py:106-140,
Temperature_Pore_MC.py:154-195); the draws come from a ``torch.Generator``,
so the state matches the JAX package's in distribution, not bitwise.  Both
draw on the generator's device unless ``device`` names another.
"""

from __future__ import annotations

import torch

from . import rng
from .config import CubeConfig, PoreConfig
from .ops import fp
from .state import ParticleState


def _device(gen: torch.Generator, device):
    return gen.device if device is None else torch.device(device)


def init_cube(cfg: CubeConfig, gen: torch.Generator,
              device=None) -> ParticleState:
    """Uniform fill of the box, or with ``cfg.stratified_init`` the
    reference's stratified fill: floor(N / c^3) particles uniform inside
    each of the c^3 cells, the remainder uniform over the box."""
    device = _device(gen, device)
    n = cfg.num_molecules
    dtype = cfg.engine.torch_dtype
    g = cfg.geometry
    extent = torch.tensor([g.lx, g.ly, g.lz], dtype=dtype, device=device)
    if cfg.stratified_init:
        c = cfg.init_cells_per_axis
        cells = c * c * c
        q, r = divmod(n, cells)
        axis = torch.arange(c, dtype=dtype, device=device)
        ijk = torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"),
                          dim=-1).reshape(cells, 1, 3)
        local = torch.rand((cells, q, 3), generator=gen, dtype=dtype,
                           device=device)
        in_cells = (fp.div(ijk + local, float(c)) * extent).reshape(
            cells * q, 3)
        rest = torch.rand((r, 3), generator=gen, dtype=dtype,
                          device=device) * extent
        pos = torch.cat([in_cells, rest])
    else:
        pos = torch.rand((n, 3), generator=gen, dtype=dtype,
                         device=device) * extent
    vel = rng.maxwell_velocities(gen, n, cfg.physics.a_shape, dtype, device)
    state = ParticleState.zeros(n, dtype, device)
    state.pos, state.vel = pos, vel
    return state


def init_pore(cfg: PoreConfig, gen: torch.Generator,
              device=None) -> ParticleState:
    """Per-segment uniform fill of the five-cylinder stack."""
    device = _device(gen, device)
    g = cfg.geometry
    ar = cfg.physics.argon_radius
    counts = g.segment_particle_counts(cfg.num_molecules)
    n = cfg.num_molecules
    dtype = cfg.engine.torch_dtype

    # (radius_inset, z_lo, z_hi) per segment, in reference order/insets.
    segments = [
        ("open_air_bottom", g.open_air_radius - ar, ar, g.open_air_height - ar),
        ("hot", g.pore_coated_radius - ar, g.open_air_height, g.gap_bottom),
        ("gap", g.gap_radius - ar, g.gap_bottom + ar, g.gap_top - ar),
        ("cold", g.pore_coated_radius - ar, g.gap_top, g.cold_top),
        ("open_air_top", g.open_air_radius - ar, g.cold_top + ar,
         g.total_height - ar),
    ]
    xs, ys, zs = [], [], []
    for name, radius, z_lo, z_hi in segments:
        m = counts[name]
        x, y = rng.uniform_disk(gen, m, radius, dtype, device)
        u = torch.rand((m,), generator=gen, dtype=dtype, device=device)
        xs.append(x)
        ys.append(y)
        zs.append(z_lo + (z_hi - z_lo) * u)
    pos = torch.stack([torch.cat(xs), torch.cat(ys), torch.cat(zs)], dim=-1)
    vel = rng.maxwell_velocities(gen, n, cfg.physics.a_shape, dtype, device)
    state = ParticleState.zeros(n, dtype, device)
    state.pos, state.vel = pos, vel
    return state
