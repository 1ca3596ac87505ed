"""The energized thruster pore (Temperature_Pore_MC.py) as a port Workload.

Port of ``argon_monte_carlo_tpu.models.temperature_pore``: specular
open-air walls (cases 1-2, no path bookkeeping), Debye thermal walls where
the coatings or the alumina gap are exposed (cases 3-6), each feeding the
per-step momentum-z / hot / cold energy ledger, and recapture after the
walls and after the pair collisions.  Predicates follow
Temperature_Pore_MC.py:690-753 verbatim.

``wall_pass`` takes the step's (N, 2) uniforms as a tensor: the engine
draws them from its Generator (or a caller's ``draw``), and one shared
trig evaluation feeds every energized case's cone draw.  The workload's
``advance`` -- drift, wall pass and post-wall recapture -- is K8
(``ops/pore_pass.py``) for CUDA tensors and that plain sequence for CPU
tensors.
"""

from __future__ import annotations

import math

import torch

from .. import rng
from ..config import PoreConfig
from ..engine import WallLedger, Workload, advance_plain
from ..init import init_pore
from ..models.base import apply_tracked
from ..ops import fp
from ..ops import oob as oob_ops
from ..ops import pore_pass
from ..ops import walls as wall_ops


def make_temperature_pore_workload(cfg: PoreConfig) -> Workload:
    if not cfg.energized:
        raise ValueError("make_temperature_pore_workload takes "
                         "energized=True; the specular pore is "
                         "make_pore_workload")
    geom = cfg.geometry
    physics = cfg.physics
    ar = physics.argon_radius
    mass = physics.mass
    h = geom.total_height
    oah = geom.open_air_height
    r_oa = geom.open_air_radius
    cr_oa = geom.open_air_collision_radius(physics)
    cr_gap = geom.gap_collision_radius(physics)
    cr_pore = geom.pore_collision_radius(physics)
    gap_lo = geom.gap_bottom
    gap_hi = geom.gap_top
    cos_cone = wall_ops.cos_cone_from_deg(cfg.cone_half_angle_deg)
    alpha_coat = cfg.coated_accommodation_coeff
    alpha_gap = cfg.gap_accommodation_coeff
    e_cold = cfg.surface_energy_cold
    e_hot = cfg.surface_energy_hot
    gap_table = cfg.gap_energy_table()
    gap_interp = wall_ops.gap_energy_interp(
        gap_table.z_lo, gap_table.z_hi, gap_table.energies
    )
    # Recapture inset scales with the geometry (the reference hard-codes
    # 50nm for the default size, Temperature_Pore_MC.py:599).
    z_inset = 0.5 * oah

    def r2(pos):
        return pos[:, 0] * pos[:, 0] + pos[:, 1] * pos[:, 1]

    def wall_pass(state, prior, measure, uniforms, cases=None):
        """The six cases in the reference's order; ``cases``, if a dict,
        receives each case's mask by name."""
        dtype, device = state.pos.dtype, state.pos.device
        trig = rng.cone_trig(uniforms, cos_cone)
        zero = torch.zeros((), dtype=dtype, device=device)
        momentum_z, energy_hot, energy_cold = zero, zero, zero
        hits = torch.zeros((), dtype=torch.int32, device=device)
        errs = torch.zeros((), dtype=torch.int32, device=device)

        pz = prior[:, 2]
        prior_r2 = r2(prior)

        def note(name, mask):
            if cases is not None:
                cases[name] = mask
            return mask

        def energized(state, measure, case_mask, event_fn):
            ev = event_fn(state, case_mask)
            state_out, measure, case_hits = apply_tracked(
                ev.state, measure, ev, case_mask, state.paths,
                state.has_collided, zero_residual=True,
            )
            return (state_out, measure, case_hits, ev.momentum_z, ev.energy,
                    torch.sum(ev.err_mask, dtype=torch.int32))

        # CASE 1: bare specular open-air cylinder side (:693-694).
        mask = note("1 open-air side", fp.sqrt(r2(state.pos)) > r_oa)
        ev = wall_ops.specular_cylinder(state, mask, cr_oa)
        state = ev.state
        errs = errs + torch.sum(ev.err_mask, dtype=torch.int32)

        # CASE 2: bare specular z caps (:699-703).
        state = wall_ops.specular_plane(
            state, note("2 bottom cap", state.pos[:, 2] < 0.0), 2, 0.0).state
        state = wall_ops.specular_plane(
            state, note("2 top cap", state.pos[:, 2] > h), 2, h).state

        # CASE 3: coated annular faces (:708-716).
        plane_cold = h - oah + ar
        mask = note("3 cold face", (pz >= plane_cold)
                    & (state.pos[:, 2] < plane_cold)
                    & (r2(state.pos) > geom.pore_coated_radius**2))
        state, measure, ch, dpz, de, er = energized(
            state, measure, mask,
            lambda s, m: wall_ops.energized_plane(
                s, m, plane_cold, 1.0, e_cold, alpha_coat, mass, trig,
            ),
        )
        hits, momentum_z, energy_cold = hits + ch, momentum_z + dpz, energy_cold + de
        errs = errs + er

        plane_hot = oah - ar
        mask = note("3 hot face", (pz <= plane_hot)
                    & (state.pos[:, 2] > plane_hot)
                    & (r2(state.pos) > geom.pore_coated_radius**2))
        state, measure, ch, dpz, de, er = energized(
            state, measure, mask,
            lambda s, m: wall_ops.energized_plane(
                s, m, plane_hot, -1.0, e_hot, alpha_coat, mass, trig,
            ),
        )
        hits, momentum_z, energy_hot = hits + ch, momentum_z + dpz, energy_hot + de
        errs = errs + er

        # CASE 4: alumina gap side wall with the temperature ramp (:720-723).
        mask = note("4 gap side", (pz < gap_hi - ar) & (pz > gap_lo + ar)
                    & (prior_r2 <= cr_gap**2)
                    & (r2(state.pos) > cr_gap**2))
        state, measure, ch, dpz, de, er = energized(
            state, measure, mask,
            lambda s, m: wall_ops.energized_cylinder(
                s, m, cr_gap, gap_interp, alpha_gap, mass, trig,
            ),
        )
        hits, momentum_z = hits + ch, momentum_z + dpz
        errs = errs + er  # the gap case tracks momentum only (:485-553)

        # CASE 5: gap cylinder bases (:728-738).
        in_gap_prior = (pz <= gap_hi - ar) & (pz >= gap_lo + ar)
        mask = note("5 gap bottom", (prior_r2 >= cr_pore**2)
                    & (state.pos[:, 2] < gap_lo + ar) & in_gap_prior)
        state, measure, ch, dpz, de, er = energized(
            state, measure, mask,
            lambda s, m: wall_ops.energized_plane(
                s, m, gap_lo + ar, 1.0, e_hot, alpha_coat, mass, trig,
            ),
        )
        hits, momentum_z, energy_hot = hits + ch, momentum_z + dpz, energy_hot + de
        errs = errs + er
        mask = note("5 gap top", (prior_r2 >= cr_pore**2)
                    & (state.pos[:, 2] > gap_hi - ar) & in_gap_prior)
        state, measure, ch, dpz, de, er = energized(
            state, measure, mask,
            lambda s, m: wall_ops.energized_plane(
                s, m, gap_hi - ar, -1.0, e_cold, alpha_coat, mass, trig,
            ),
        )
        hits, momentum_z, energy_cold = hits + ch, momentum_z + dpz, energy_cold + de
        errs = errs + er

        # CASE 6: coated pore side wall, hot then cold bands (:743-753).
        crossed = (prior_r2 <= cr_pore**2) & (r2(state.pos) > cr_pore**2)
        z = state.pos[:, 2]
        mask = note("6 hot side", crossed & (z <= gap_lo + ar)
                    & (z >= oah - ar))
        state, measure, ch, dpz, de, er = energized(
            state, measure, mask,
            lambda s, m: wall_ops.energized_cylinder(
                s, m, cr_pore, e_hot, alpha_coat, mass, trig,
            ),
        )
        hits, momentum_z, energy_hot = hits + ch, momentum_z + dpz, energy_hot + de
        errs = errs + er
        crossed = (prior_r2 <= cr_pore**2) & (r2(state.pos) > cr_pore**2)
        z = state.pos[:, 2]
        mask = note("6 cold side", crossed & (z < h - oah + ar)
                    & (z > gap_hi - ar))
        state, measure, ch, dpz, de, er = energized(
            state, measure, mask,
            lambda s, m: wall_ops.energized_cylinder(
                s, m, cr_pore, e_cold, alpha_coat, mass, trig,
            ),
        )
        hits, momentum_z, energy_cold = hits + ch, momentum_z + dpz, energy_cold + de
        errs = errs + er

        ledger = WallLedger(
            momentum_z=momentum_z, energy_hot=energy_hot,
            energy_cold=energy_cold, wall_hits=hits, errs=errs,
        )
        return state, measure, ledger

    def recapture(state):
        return oob_ops.pore_recapture(state, geom, z_inset)

    plain = advance_plain(wall_pass, recapture, cfg.dt)
    params = pore_pass.PoreParams(
        values=dict(
            dt=cfg.dt, r_oa=r_oa, cr_oa=cr_oa, cr_oa_rr=cr_oa * cr_oa, h=h,
            plane_cold=h - oah + ar, plane_hot=oah - ar,
            rc_sq=geom.pore_coated_radius**2, e_cold=e_cold, e_hot=e_hot,
            alpha_coat=alpha_coat, alpha_gap=alpha_gap, mass=mass,
            half_mass=0.5 * mass, gap_hi_m_ar=gap_hi - ar,
            gap_lo_p_ar=gap_lo + ar, cr_gap=cr_gap, cr_gap_sq=cr_gap**2,
            cr_gap_rr=cr_gap * cr_gap, cr_pore=cr_pore,
            cr_pore_sq=cr_pore**2, cr_pore_rr=cr_pore * cr_pore,
            cos_cone=cos_cone, one_m_cos=1.0 - cos_cone,
            two_pi=2.0 * math.pi, table_z_lo=gap_interp.z_lo,
            table_span=gap_interp.z_hi - gap_interp.z_lo,
            z_inset=z_inset, h_m_z_inset=h - z_inset,
            r_oa_sq=geom.open_air_radius**2, oah=geom.open_air_height,
            h_m_oah=h - geom.open_air_height, gap_r_sq=geom.gap_radius**2,
            gap_bottom=geom.gap_bottom, gap_top=geom.gap_top,
        ),
        horner=gap_interp.power,
    )

    def advance(state, measure, uniforms):
        return pore_pass.pore_advance(state, measure, uniforms, params,
                                      plain)

    return Workload(
        cfg=cfg,
        init_fn=lambda gen, device: init_pore(cfg, gen, device),
        wall_pass=wall_pass,
        advance=advance,
        advance_plain=plain,
        post_pairs=recapture,
        fluid_volume=geom.volume,
    )
