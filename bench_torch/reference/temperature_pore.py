"""The energized pore (Temperature_Pore_MC.py): its set-up from a
configuration file, its initial fill, and its walls in a step -- the six
wall cases and recapture before the pair collisions, recapture again
after them."""

from __future__ import annotations

import math

import torch

from . import walls as W
from .model import Pore, Setup, gap_energy_power, surface_energy


def setup(cfg: dict, gas, dt: float, num_bins: int, hist_hi: float):
    """The pore, scaled at the gas's density to ``target_particles``
    where the file gives it, and its Debye surface energies."""
    pore = Pore(**cfg["geometry"])
    target = cfg.get("target_particles")
    if target is not None:
        pore = pore.scaled((target / gas.num_molecules(pore.volume))
                           ** (1.0 / 3.0))
    th = dict(cfg["thermal"])
    e_cold = float(surface_energy(th["t_cold"], th["t_debye_graphene"],
                                  th["atoms_graphene"], gas.boltzmann))
    e_hot = float(surface_energy(th["t_hot"], th["t_debye_graphene"],
                                 th["atoms_graphene"], gas.boltzmann))
    power = gap_energy_power(pore.gap_bottom, pore.gap_top, th["t_hot"],
                             th["t_cold"], gas.boltzmann,
                             th["t_debye_alumina"], th["atoms_alumina"])
    th.update(e_cold=e_cold, e_hot=e_hot, gap_power=power,
              cos_cone=math.cos(math.radians(th["cone_half_angle_deg"])))
    return Setup(cfg["workload"], gas, gas.num_molecules(pore.volume),
                 dt, num_bins, hist_hi, geometry=pore, params=th)


def draw_positions(setup: Setup, rand, device) -> torch.Tensor:
    """Each segment's uniform fill of its cylinder (r sqrt(u), 2 pi u, z
    uniform), segment by segment; ``rand(shape)`` draws float32
    uniforms."""
    g, ar = setup.geometry, setup.gas.argon_radius
    counts = g.segment_counts(setup.n)
    segments = [
        ("open_air_bottom", g.open_air_radius - ar, ar,
         g.open_air_height - ar),
        ("hot", g.pore_coated_radius - ar, g.open_air_height, g.gap_bottom),
        ("gap", g.gap_radius - ar, g.gap_bottom + ar, g.gap_top - ar),
        ("cold", g.pore_coated_radius - ar, g.gap_top, g.cold_top),
        ("open_air_top", g.open_air_radius - ar, g.cold_top + ar,
         g.total_height - ar),
    ]
    xs, ys, zs = [], [], []
    for name, radius, z_lo, z_hi in segments:
        m = counts[name]
        u = rand((m,))
        theta = (2.0 * math.pi) * rand((m,))
        r = radius * W.sqrt(u)
        xs.append(r * torch.cos(theta))
        ys.append(r * torch.sin(theta))
        zs.append(z_lo + (z_hi - z_lo) * rand((m,)))
    return torch.stack([torch.cat(xs), torch.cat(ys), torch.cat(zs)], -1)


def walls(S, prior, uniforms, setup: Setup):
    """The six wall cases, then recapture: (momentum_z, energy_hot,
    energy_cold, wall hits) of the step."""
    mom, e_h, e_c, hits, _ = W.pore_walls(S, prior, uniforms, setup)
    W.pore_recapture(S, setup)
    return mom, e_h, e_c, hits


def after_collisions(S, setup: Setup) -> None:
    W.pore_recapture(S, setup)
