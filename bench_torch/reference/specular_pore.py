"""The specular pore (Open_Air_Pore_MC.py, the reference's stage 2): its
set-up from a configuration file, its initial fill, and its walls in a
step -- the six specular wall cases (:439-485), each ending the free path
of every particle it takes (:257-348), then the audit and nudge (:354-375)
before the pair collisions and again after them.  It draws nothing after
the initial state and keeps no momentum or energy ledger.

Departures from the script, each shared by the program under test:

- every case is a masked transform of the whole arrays, applied in the
  script's case order, in place of its loop over the particles that a
  case takes; a particle that two cases take in one step meets them in
  the script's order, the second from where the first left it;
- a lane whose back-trace to a cylinder has no root (the script's
  "potential lost particle", :336-338) is counted as a hit, as there, and
  left where the drift put it; its free path runs on;
- the audit prints nothing: it only nudges (a z stray back by 10 argon
  radii, a radial stray to the axis, each radial check on the updated
  coordinates);
- the fill is the energized pore's (``temperature_pore.draw_positions``):
  the same five segments, counts and insets (:106-140), drawn from the
  seed's float32 uniforms;
- the pore is scaled at ambient density to the file's
  ``target_particles``, and the arithmetic runs in the configuration's
  precision (float32), not the script's float64.
"""

from __future__ import annotations

import torch

from . import walls as W
from .model import Pore, Setup
from .temperature_pore import draw_positions  # noqa: F401  (the fill)


def setup(cfg: dict, gas, dt: float, num_bins: int, hist_hi: float):
    """The pore, scaled at the gas's density to ``target_particles``
    where the file gives it."""
    pore = Pore(**cfg["geometry"])
    target = cfg.get("target_particles")
    if target is not None:
        pore = pore.scaled((target / gas.num_molecules(pore.volume))
                           ** (1.0 / 3.0))
    return Setup(cfg["workload"], gas, gas.num_molecules(pore.volume), dt,
                 num_bins, hist_hi, geometry=pore)


def _radius(p):
    return W.sqrt(p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1])


def _plane(S, mask, level):
    """A specular z-plane: reflect, stage the completed path, keep the
    residual |v'| t; every lane of the case is a hit."""
    t = (S["pos"][:, 2] - level) / W._safe(S["vel"][:, 2])
    before = S["vel"]
    W.specular_plane(S, mask, 2, level)
    W.record_completed(S, before, t, mask)
    W.end_paths(S, mask, t, S["vel"], zero_residual=False)
    return torch.sum(mask, dtype=torch.int32)


def _cylinder(S, mask, radius):
    """A specular side wall at ``radius``: as ``_plane``; the lanes
    without a back-trace root are hits that nothing handles."""
    t, _ = W._backtrace(S["pos"], S["vel"], radius)
    before = S["vel"]
    handled = mask & ~W.specular_cylinder(S, mask, radius)
    W.record_completed(S, before, t, handled)
    W.end_paths(S, handled, t, S["vel"], zero_residual=False)
    return torch.sum(mask, dtype=torch.int32)


def nudge(S, setup: Setup) -> None:
    """The audit and nudge (Open_Air_Pore_MC.py:354-375)."""
    g, ar = setup.geometry, setup.gas.argon_radius
    x, y, z = S["pos"][:, 0], S["pos"][:, 1], S["pos"][:, 2]
    h, oah = g.total_height, g.open_air_height
    zero = torch.zeros_like(x)
    z = torch.where(z < 0.0, z + 10.0 * ar, z)
    z = torch.where(z > h, z - 10.0 * ar, z)
    m = x * x + y * y > g.open_air_radius ** 2
    x, y = torch.where(m, zero, x), torch.where(m, zero, y)
    inside = (z > oah) & (z < h - oah)
    m = (x * x + y * y > g.gap_radius ** 2) & inside
    x, y = torch.where(m, zero, x), torch.where(m, zero, y)
    coated = ((z > oah) & (z < g.gap_bottom)) | ((z > g.gap_top)
                                                 & (z < h - oah))
    m = (x * x + y * y > g.pore_coated_radius ** 2) & coated
    x, y = torch.where(m, zero, x), torch.where(m, zero, y)
    S["pos"] = torch.stack([x, y, z], dim=-1)


def walls(S, prior, uniforms, setup: Setup, cases=None):
    """The six cases in the script's order, then the nudge: (momentum_z,
    energy_hot, energy_cold, wall hits) of the step, the first three 0.
    ``uniforms`` is unused; ``cases``, a dict, receives each case's
    mask."""
    del uniforms
    g, ar = setup.geometry, setup.gas.argon_radius
    h, oah = g.total_height, g.open_air_height
    r_oa, r_gap = g.open_air_radius, g.gap_radius
    r_pore = g.pore_coated_radius
    gap_lo, gap_hi = g.gap_bottom, g.gap_top
    pz, prior_r = prior[:, 2], _radius(prior)
    hits = torch.zeros((), dtype=torch.int32, device=prior.device)

    def case(name, mask, apply, where):
        nonlocal hits
        if cases is not None:
            cases[name] = mask
        hits = hits + apply(S, mask, where)

    # 1: the open air's side (:442-443); 2: the outer caps (:448-452).
    case("1 open-air side", _radius(S["pos"]) > r_oa, _cylinder, r_oa - ar)
    case("2 bottom cap", S["pos"][:, 2] < 0.0, _plane, 0.0)
    case("2 top cap", S["pos"][:, 2] > h, _plane, h)
    # 3: the annular faces where the open air meets the pore (:457-461).
    case("3 cold face", (pz > h - oah) & (S["pos"][:, 2] < h - oah)
         & (_radius(S["pos"]) > r_pore), _plane, h - oah)
    case("3 hot face", (pz < oah) & (S["pos"][:, 2] > oah)
         & (_radius(S["pos"]) > r_pore), _plane, oah)
    # 4: the gap's side wall, crossed from inside (:465-467).
    case("4 gap side", (pz < h - oah - g.cold_coating_height)
         & (pz > gap_lo) & (prior_r < r_gap) & (_radius(S["pos"]) > r_gap),
         _cylinder, r_gap - ar)
    # 5: the gap cylinder's bases (:472-478).
    in_gap = (pz < gap_hi) & (pz > gap_lo)
    case("5 gap bottom", (prior_r > r_pore) & (S["pos"][:, 2] < gap_lo)
         & in_gap, _plane, gap_lo)
    case("5 gap top", (prior_r > r_pore) & (S["pos"][:, 2] > gap_hi)
         & in_gap, _plane, gap_hi)
    # 6: the coated pore's side wall, both bands (:482-485).
    z = S["pos"][:, 2]
    band = ((z < h - oah) & (z > gap_hi)) | ((z < gap_lo) & (z > oah))
    case("6 pore side", (prior_r < r_pore) & (_radius(S["pos"]) > r_pore)
         & band, _cylinder, r_pore - ar)
    nudge(S, setup)
    zero = torch.zeros((), dtype=S["pos"].dtype, device=prior.device)
    return zero, zero, zero, hits


def after_collisions(S, setup: Setup) -> None:
    nudge(S, setup)
