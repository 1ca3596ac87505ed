"""The reference's wall pass: the temperature pore's six wall cases
(Temperature_Pore_MC.py:690-753) and recapture (:594-616), and the cube's
six specular planes (Open_Air_Cube_MC.py:189-226).

Plain PyTorch on whole arrays, each case a masked transform applied in the
reference scripts' order; operations are written in the order of the
scripts' own arithmetic, each rounded once.  ``S`` is a dict with pos,
vel, paths, has_collided, and the staging ``vals`` / ``staged`` of the
step's completed free paths.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """IEEE square root on every device (the CPU's vectorised one is not)."""
    if x.device.type == "cpu" and x.dtype in (torch.float32, torch.float64):
        return torch.as_tensor(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as a true division (CUDA divides by a Python scalar as a
    multiplication by its reciprocal)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def speed(vel):
    vx, vy, vz = vel[:, 0], vel[:, 1], vel[:, 2]
    return sqrt(vx * vx + vy * vy + vz * vz)


def path_components(vel):
    """(N, 4) |v| along the path axes: total, x, y, z."""
    return torch.stack([speed(vel), vel[:, 0].abs(), vel[:, 1].abs(),
                        vel[:, 2].abs()], dim=-1)


def record_completed(S, vel_before, t, mask):
    """Stage |path_k - |v_k| t| for masked particles whose partial path
    already ended (Open_Air_Cube_MC.py:267-272)."""
    emit = mask & S["has_collided"]
    comps = torch.abs(S["paths"] - path_components(vel_before) * t[:, None])
    S["vals"] = torch.where(emit[:, None], comps, S["vals"])
    S["staged"] = S["staged"] | emit


def end_paths(S, mask, t, vel_after, zero_residual):
    if zero_residual:
        residual = torch.zeros_like(S["paths"])
    else:
        residual = torch.abs(path_components(vel_after) * t[:, None])
    S["paths"] = torch.where(mask[:, None], residual, S["paths"])
    S["has_collided"] = S["has_collided"] | mask


def _safe(x):
    return torch.where(x == 0.0, torch.ones_like(x), x)


def _with_column(x, axis, col):
    cols = list(x.unbind(dim=1))
    cols[axis] = col
    return torch.stack(cols, dim=1)


def specular_plane(S, mask, axis, plane):
    p, v = S["pos"][:, axis], S["vel"][:, axis]
    t = (p - plane) / _safe(v)
    new_v = -v
    new_p = plane + t * new_v
    S["pos"] = _with_column(S["pos"], axis, torch.where(mask, new_p, p))
    S["vel"] = _with_column(S["vel"], axis, torch.where(mask, new_v, v))


def _backtrace(pos, vel, radius):
    """Smaller root of |p_xy - v_xy t|^2 = R^2, and where it exists."""
    x, y = pos[:, 0], pos[:, 1]
    vx, vy = vel[:, 0], vel[:, 1]
    a = vx * vx + vy * vy
    b = -2.0 * (x * vx + y * vy)
    c = x * x + y * y - radius * radius
    disc = b * b - 4.0 * a * c
    ok = (disc >= 0.0) & (a > 0.0)
    t = (-b - sqrt(torch.clamp(disc, min=0.0))) / (2.0 * _safe(a))
    return t, ok


def specular_cylinder(S, mask, radius):
    """Reflect (vx, vy) about the side wall's normal at the impact point
    and replay the rest of the step; returns the solver's failures."""
    t, ok = _backtrace(S["pos"], S["vel"], radius)
    handled = mask & ok
    x, y = S["pos"][:, 0], S["pos"][:, 1]
    vx, vy = S["vel"][:, 0], S["vel"][:, 1]
    col_x, col_y = x - vx * t, y - vy * t
    nx, ny = div(col_x, radius), div(col_y, radius)
    dot = vx * nx + vy * ny
    new_vx = vx - 2.0 * dot * nx
    new_vy = vy - 2.0 * dot * ny
    S["pos"] = torch.stack([torch.where(handled, col_x + new_vx * t, x),
                            torch.where(handled, col_y + new_vy * t, y),
                            S["pos"][:, 2]], dim=1)
    S["vel"] = torch.stack([torch.where(handled, new_vx, vx),
                            torch.where(handled, new_vy, vy),
                            S["vel"][:, 2]], dim=1)
    return mask & ~ok


def _cone_trig(uniforms, cos_half):
    u1, u2 = uniforms[..., 0], uniforms[..., 1]
    cos_t = cos_half + u1 * (1.0 - cos_half)
    sin_t = sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = (2.0 * math.pi) * u2
    return cos_t, sin_t * torch.cos(phi), sin_t * torch.sin(phi)


def _frame(n):
    """Branchless tangent frame of unit normals (Duff et al. 2017)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    one = torch.ones_like(nz)
    s = torch.where(nz >= 0.0, one, -one)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    e1 = torch.stack([1.0 + s * nx * nx * a, s * b, -s * nx], dim=-1)
    e2 = torch.stack([b, s + ny * ny * a, -ny], dim=-1)
    return e1, e2


def _thermal(vel, e_surf, alpha, mass):
    """E' = E + (E_surf - E) alpha: the new speed and the energy change."""
    s2 = vel[:, 0] * vel[:, 0] + vel[:, 1] * vel[:, 1] + vel[:, 2] * vel[:, 2]
    energy = 0.5 * mass * s2
    new_e = energy + (e_surf - energy) * alpha
    return sqrt(torch.clamp(div(new_e * 2.0, mass), min=0.0)), new_e - energy


def _track(S, mask_case, handled, t, vel_before, paths0, has0):
    """A thermal wall ends the free path: stage it, keep no residual."""
    emit = handled & has0
    comps = torch.abs(paths0 - path_components(vel_before) * t[:, None])
    S["vals"] = torch.where(emit[:, None], comps, S["vals"])
    S["staged"] = S["staged"] | emit
    S["paths"] = torch.where(handled[:, None], torch.zeros_like(S["paths"]),
                             S["paths"])
    S["has_collided"] = S["has_collided"] | handled
    return torch.sum(mask_case, dtype=torch.int32)


def energized_plane(S, mask, plane, sign, e_surf, alpha, mass, trig):
    """Thermal z-plane: placed at the impact point, re-emitted in the cone
    about (0, 0, sign) (Temperature_Pore_MC.py:349-412)."""
    pos, vel = S["pos"], S["vel"]
    paths0, has0 = S["paths"], S["has_collided"]
    vz = vel[:, 2]
    t = (pos[:, 2] - plane) / _safe(vz)
    col_x = pos[:, 0] - vel[:, 0] * t
    col_y = pos[:, 1] - vel[:, 1] * t
    cos_t, a, b = trig
    direction = torch.stack([a, b, sign * cos_t], dim=-1)
    new_speed, d_e = _thermal(vel, e_surf, alpha, mass)
    new_vel = direction * new_speed[:, None]
    d_pz = mass * (new_vel[:, 2] - vz)
    mf = mask.to(pos.dtype)
    new_pos = torch.stack([col_x, col_y, torch.full_like(col_x, plane)], -1)
    S["pos"] = torch.where(mask[:, None], new_pos, pos)
    S["vel"] = torch.where(mask[:, None], new_vel, vel)
    hits = _track(S, mask, mask, t, vel, paths0, has0)
    zero = torch.zeros((), dtype=torch.int32, device=pos.device)
    return hits, torch.sum(mf * d_pz), torch.sum(mf * d_e), zero


def energized_cylinder(S, mask, radius, e_surf, alpha, mass, trig):
    """Thermal side wall (Temperature_Pore_MC.py:414-553); ``e_surf`` a
    constant or a function of the impact z."""
    pos, vel = S["pos"], S["vel"]
    paths0, has0 = S["paths"], S["has_collided"]
    t, ok = _backtrace(pos, vel, radius)
    handled = mask & ok
    col = pos - vel * t[:, None]
    inward = torch.stack([div(-col[:, 0], radius), div(-col[:, 1], radius),
                          torch.zeros_like(t)], dim=-1)
    cos_t, a, b = trig
    e1, e2 = _frame(inward)
    direction = (cos_t[..., None] * inward + a[..., None] * e1
                 + b[..., None] * e2)
    es = e_surf(col[:, 2]) if callable(e_surf) else e_surf
    new_speed, d_e = _thermal(vel, es, alpha, mass)
    new_vel = direction * new_speed[:, None]
    d_pz = mass * (new_vel[:, 2] - vel[:, 2])
    mf = handled.to(pos.dtype)
    S["pos"] = torch.where(handled[:, None], col, pos)
    S["vel"] = torch.where(handled[:, None], new_vel, vel)
    hits = _track(S, mask, handled, t, vel, paths0, has0)
    return (hits, torch.sum(mf * d_pz), torch.sum(mf * d_e),
            torch.sum(mask & ~ok, dtype=torch.int32))


def gap_energy(power, z_lo, z_hi):
    def e_surf(z):
        t = torch.clamp(div(z - z_lo, z_hi - z_lo) * 2.0 - 1.0, -1.0, 1.0)
        acc = torch.full_like(t, power[0])
        for c in power[1:]:
            acc = acc * t + c
        return acc
    return e_surf


def pore_walls(S, prior, uniforms, setup, cases=None):
    """The six wall cases of the energized pore in the script's order.
    Returns the step's ledger: (momentum_z, energy_hot, energy_cold,
    wall_hits, errors).  ``cases``, a dict, receives each case's mask."""
    g, gas, th = setup.geometry, setup.gas, setup.params
    ar, mass = gas.argon_radius, gas.mass
    h, oah = g.total_height, g.open_air_height
    cr_oa = g.open_air_radius - ar
    cr_gap = g.gap_radius - ar
    cr_pore = g.pore_coated_radius - ar
    gap_lo, gap_hi = g.gap_bottom, g.gap_top
    alpha_c, alpha_g = th["coated_accommodation"], th["gap_accommodation"]
    e_cold, e_hot = th["e_cold"], th["e_hot"]
    trig = _cone_trig(uniforms, th["cos_cone"])
    dev, dtype = S["pos"].device, S["pos"].dtype
    mom = e_h = e_c = torch.zeros((), dtype=dtype, device=dev)
    hits = errs = torch.zeros((), dtype=torch.int32, device=dev)

    def r2(p):
        return p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1]

    def note(name, m):
        if cases is not None:
            cases[name] = m
        return m

    pz, prior_r2 = prior[:, 2], r2(prior)
    # 1: specular open-air side; 2: specular caps.
    m = note("1 open-air side", sqrt(r2(S["pos"])) > g.open_air_radius)
    errs = errs + torch.sum(specular_cylinder(S, m, cr_oa), dtype=torch.int32)
    specular_plane(S, note("2 bottom cap", S["pos"][:, 2] < 0.0), 2, 0.0)
    specular_plane(S, note("2 top cap", S["pos"][:, 2] > h), 2, h)

    def plane(name, cond, z, sign, es, which):
        nonlocal hits, mom, e_h, e_c, errs
        m = note(name, cond)
        ch, dp, de, er = energized_plane(S, m, z, sign, es, alpha_c, mass,
                                         trig)
        hits, mom, errs = hits + ch, mom + dp, errs + er
        if which == "cold":
            e_c = e_c + de
        else:
            e_h = e_h + de

    def side(name, cond, radius, es, alpha, which):
        nonlocal hits, mom, e_h, e_c, errs
        m = note(name, cond)
        ch, dp, de, er = energized_cylinder(S, m, radius, es, alpha, mass,
                                            trig)
        hits, mom, errs = hits + ch, mom + dp, errs + er
        if which == "cold":
            e_c = e_c + de
        elif which == "hot":
            e_h = e_h + de

    rc2 = g.pore_coated_radius ** 2
    # 3: the coated annular faces.
    pc = h - oah + ar
    plane("3 cold face", (pz >= pc) & (S["pos"][:, 2] < pc)
          & (r2(S["pos"]) > rc2), pc, 1.0, e_cold, "cold")
    ph = oah - ar
    plane("3 hot face", (pz <= ph) & (S["pos"][:, 2] > ph)
          & (r2(S["pos"]) > rc2), ph, -1.0, e_hot, "hot")
    # 4: the alumina gap's side wall with its temperature ramp (momentum
    # only in the ledger).
    side("4 gap side", (pz < gap_hi - ar) & (pz > gap_lo + ar)
         & (prior_r2 <= cr_gap ** 2) & (r2(S["pos"]) > cr_gap ** 2), cr_gap,
         gap_energy(th["gap_power"], gap_lo, gap_hi), alpha_g, None)
    # 5: the gap cylinder's bases.
    in_gap = (pz <= gap_hi - ar) & (pz >= gap_lo + ar)
    plane("5 gap bottom", (prior_r2 >= cr_pore ** 2)
          & (S["pos"][:, 2] < gap_lo + ar) & in_gap, gap_lo + ar, 1.0,
          e_hot, "hot")
    plane("5 gap top", (prior_r2 >= cr_pore ** 2)
          & (S["pos"][:, 2] > gap_hi - ar) & in_gap, gap_hi - ar, -1.0,
          e_cold, "cold")
    # 6: the coated pore's side wall, hot band then cold band.
    crossed = (prior_r2 <= cr_pore ** 2) & (r2(S["pos"]) > cr_pore ** 2)
    z = S["pos"][:, 2]
    side("6 hot side", crossed & (z <= gap_lo + ar) & (z >= oah - ar),
         cr_pore, e_hot, alpha_c, "hot")
    crossed = (prior_r2 <= cr_pore ** 2) & (r2(S["pos"]) > cr_pore ** 2)
    z = S["pos"][:, 2]
    side("6 cold side", crossed & (z < h - oah + ar) & (z > gap_hi - ar),
         cr_pore, e_cold, alpha_c, "cold")
    return mom, e_h, e_c, hits, errs


def pore_recapture(S, setup):
    """Teleport escapees inside: z first, then the radial checks on the
    updated z (Temperature_Pore_MC.py:594-616); the inset is half the
    open-air height."""
    g = setup.geometry
    x, y, z = S["pos"][:, 0], S["pos"][:, 1], S["pos"][:, 2]
    h, oah = g.total_height, g.open_air_height
    inset = 0.5 * oah
    zero = torch.zeros_like(x)
    z = torch.where(z < 0.0, torch.full_like(z, inset), z)
    z = torch.where(z > h, torch.full_like(z, h - inset), z)
    out = [x * x + y * y > g.open_air_radius ** 2]
    x, y = torch.where(out[0], zero, x), torch.where(out[0], zero, y)
    inside = (z > oah) & (z < h - oah)
    m = (x * x + y * y > g.gap_radius ** 2) & inside
    x, y = torch.where(m, zero, x), torch.where(m, zero, y)
    coated = ((z > oah) & (z < g.gap_bottom)) | ((z > g.gap_top)
                                                  & (z < h - oah))
    m = (x * x + y * y > g.pore_coated_radius ** 2) & coated
    x, y = torch.where(m, zero, x), torch.where(m, zero, y)
    S["pos"] = torch.stack([x, y, z], dim=-1)


def cube_walls(S, setup):
    """The box's six specular planes: x, y, z, each high then low."""
    for axis, hi in enumerate(setup.geometry):
        specular_plane(S, S["pos"][:, axis] > hi, axis, hi)
        specular_plane(S, S["pos"][:, axis] < 0.0, axis, 0.0)
