"""The specular thruster pore (Open_Air_Pore_MC.py) as a port Workload.

Port of ``argon_monte_carlo_tpu.models.pore``: all six wall cases are
specular, but -- unlike the cube -- every wall hit ends the particle's free
path and counts as a collision (Open_Air_Pore_MC.py:257-348).  The combined
audit and nudge runs after the walls and after the pair collisions
(Open_Air_Pore_MC.py:512, 550).  Predicates follow Open_Air_Pore_MC.py:
439-485 verbatim (sqrt-radius comparisons, crossing detection from the
prior position).

The workload draws nothing after the initial state, so two engines started
from one state must agree to the bit; the sharded engine's exact gates run
on it.  Its ``advance`` is plain PyTorch on every device: it holds no
kernel (K8 is the temperature pore's).
"""

from __future__ import annotations

import torch

from ..config import PoreConfig
from ..engine import WallLedger, Workload, advance_plain
from ..init import init_pore
from ..models.base import apply_tracked
from ..ops import fp
from ..ops import oob as oob_ops
from ..ops import walls as wall_ops


def make_pore_workload(cfg: PoreConfig) -> Workload:
    if cfg.energized:
        raise ValueError("make_pore_workload takes energized=False; the "
                         "energized pore is make_temperature_pore_workload")
    geom = cfg.geometry
    physics = cfg.physics
    h = geom.total_height
    oah = geom.open_air_height
    r_oa = geom.open_air_radius
    r_pore = geom.pore_coated_radius
    r_gap = geom.gap_radius
    cr_oa = geom.open_air_collision_radius(physics)
    cr_gap = geom.gap_collision_radius(physics)
    cr_pore = geom.pore_collision_radius(physics)
    gap_lo = geom.gap_bottom
    gap_hi = geom.gap_top

    def radius(pos):
        return fp.sqrt(pos[:, 0] * pos[:, 0] + pos[:, 1] * pos[:, 1])

    def wall_pass(state, prior, measure, uniforms, cases=None):
        """The six cases in the reference's order; ``cases``, if a dict,
        receives each case's mask by name.  ``uniforms`` is unused."""
        del uniforms
        device = state.pos.device
        totals = {"hits": torch.zeros((), dtype=torch.int32, device=device),
                  "errs": torch.zeros((), dtype=torch.int32, device=device)}
        pz = prior[:, 2]
        prior_r = radius(prior)

        def tracked(state, measure, name, mask, event_fn):
            if cases is not None:
                cases[name] = mask
            ev = event_fn(state, mask)
            out, measure, hits = apply_tracked(
                ev.state, measure, ev, mask, state.paths,
                state.has_collided, zero_residual=False)
            totals["hits"] = totals["hits"] + hits
            totals["errs"] = totals["errs"] + torch.sum(ev.err_mask,
                                                        dtype=torch.int32)
            return out, measure

        def plane(level):
            return lambda s, m: wall_ops.specular_plane(s, m, 2, level)

        def cylinder(r):
            return lambda s, m: wall_ops.specular_cylinder(s, m, r)

        # CASE 1: specular side of the open-air cylinder (:442-443).
        state, measure = tracked(state, measure, "1 open-air side",
                                 radius(state.pos) > r_oa, cylinder(cr_oa))

        # CASE 2: exterior z caps (:448-452).
        state, measure = tracked(state, measure, "2 bottom cap",
                                 state.pos[:, 2] < 0.0, plane(0.0))
        state, measure = tracked(state, measure, "2 top cap",
                                 state.pos[:, 2] > h, plane(h))

        # CASE 3: annular faces where open air meets the pore (:457-461).
        mask = ((pz > h - oah) & (state.pos[:, 2] < h - oah)
                & (radius(state.pos) > r_pore))
        state, measure = tracked(state, measure, "3 cold face", mask,
                                 plane(h - oah))
        mask = ((pz < oah) & (state.pos[:, 2] > oah)
                & (radius(state.pos) > r_pore))
        state, measure = tracked(state, measure, "3 hot face", mask,
                                 plane(oah))

        # CASE 4: gap interior side wall (:465-467).
        mask = ((pz < h - oah - geom.cold_coating_height) & (pz > gap_lo)
                & (prior_r < r_gap) & (radius(state.pos) > r_gap))
        state, measure = tracked(state, measure, "4 gap side", mask,
                                 cylinder(cr_gap))

        # CASE 5: gap cylinder bases (:472-478).
        in_gap_prior = (pz < gap_hi) & (pz > gap_lo)
        mask = (prior_r > r_pore) & (state.pos[:, 2] < gap_lo) & in_gap_prior
        state, measure = tracked(state, measure, "5 gap bottom", mask,
                                 plane(gap_lo))
        mask = (prior_r > r_pore) & (state.pos[:, 2] > gap_hi) & in_gap_prior
        state, measure = tracked(state, measure, "5 gap top", mask,
                                 plane(gap_hi))

        # CASE 6: coated pore side wall, treated as specular (:482-485).
        z = state.pos[:, 2]
        in_cold = (z < h - oah) & (z > gap_hi)
        in_hot = (z < gap_lo) & (z > oah)
        mask = ((prior_r < r_pore) & (radius(state.pos) > r_pore)
                & (in_cold | in_hot))
        state, measure = tracked(state, measure, "6 pore side", mask,
                                 cylinder(cr_pore))

        zero = torch.zeros((), dtype=state.pos.dtype, device=device)
        ledger = WallLedger(momentum_z=zero, energy_hot=zero,
                            energy_cold=zero, wall_hits=totals["hits"],
                            errs=totals["errs"])
        return state, measure, ledger

    def fix(state):
        return oob_ops.pore_v1_audit_nudge(state, geom, physics)

    advance = advance_plain(wall_pass, fix, cfg.dt)
    return Workload(
        cfg=cfg,
        init_fn=lambda gen, device: init_pore(cfg, gen, device),
        wall_pass=wall_pass,
        advance=advance,
        advance_plain=advance,
        post_pairs=fix,
        fluid_volume=geom.volume,
    )
