"""Vectorized particle initialization (port of ``init.init_pore``).

Same segment counts, radii and z ranges as the reference
(Open_Air_Pore_MC.py:106-140, Temperature_Pore_MC.py:154-195); the draws
come from a ``torch.Generator``, so the state matches the JAX package's in
distribution, not bitwise.
"""

from __future__ import annotations

import torch

from . import rng
from .config import PoreConfig
from .state import ParticleState


def init_pore(cfg: PoreConfig, gen: torch.Generator,
              device="cpu") -> ParticleState:
    """Per-segment uniform fill of the five-cylinder stack."""
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
