"""The plain reference of a run's first steps: the initial state drawn from
the seed, then each step's drift and path accrual, wall pass, recapture,
pair collisions and histogram flush, in the reference scripts' order.

The pair collisions take the exact semantics of the reference's sweep:
every particle's partner is the lowest-index other particle whose centre
lies within the collision range, found here by a plain cell list with no
capacity (no particle is ever dropped); a mutual pair that overlaps and
approaches rewinds to contact, exchanges its impulse along the normal and
replays the step's rest.  Every completed free path enters the histogram
(no flush capacity).  ``dtype`` is the precision of the arithmetic; the
draws are made in float32, as the program makes them, and rounded to it.
"""

from __future__ import annotations

import torch

from . import walls as W
from .model import Setup, kind

NO_PARTNER = 1 << 30


def draw_initial(setup: Setup, gen: torch.Generator, device) -> dict:
    """The initial state from the seeded generator: the positions by the
    workload's kind, then Maxwell velocities a * N(0, I_3)."""
    f32, n = torch.float32, setup.n

    def rand(shape):
        return torch.rand(shape, generator=gen, dtype=f32, device=device)

    pos = kind(setup.kind).draw_positions(setup, rand, device)
    vel = setup.gas.a_shape * torch.randn((n, 3), generator=gen, dtype=f32,
                                          device=device)
    return dict(pos=pos, vel=vel,
                paths=torch.zeros((n, 4), dtype=f32, device=device),
                has_collided=torch.zeros(n, dtype=torch.bool, device=device))


ROW_CAP = 32      # a cell with more particles is searched on its own
BLOCK = 1 << 24   # candidate pairs formed at once


def _d2(a, b):
    """(dx*dx + dy*dy) + dz*dz of each row of ``a`` with each of ``b``."""
    d = a[:, None, :] - b[None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    return d2 + d[..., 2] * d[..., 2]


def lowest_partner(pos: torch.Tensor, r: float):
    """(N,) int64: for each particle the lowest index j != i with
    (dx*dx + dy*dy) + dz*dz < r*r, dx = x_i - x_j; -1 for none.  A cell
    list of side >= r over the particles' bounding box: each particle
    meets every particle of its 27 cells.  Cells of up to ``ROW_CAP``
    particles go through a padded table; each fuller cell meets the
    particles of its 27 cells as one block, both ways, so nothing is left
    out however the particles crowd."""
    n, dev = pos.shape[0], pos.device
    best = torch.full((n,), NO_PARTNER, dtype=torch.int64, device=dev)
    if n == 0:
        return best.fill_(-1)
    lo = pos.amin(dim=0).double()
    span = (pos.amax(dim=0).double() - lo)
    side = max(r * 1.001, float(span.max()) / 2.0e5, 1e-30)
    ijk = torch.floor((pos.double() - lo) / side).long() + 1
    dims = ijk.amax(dim=0) + 2
    key = (ijk[:, 0] * dims[1] + ijk[:, 1]) * dims[2] + ijk[:, 2]
    order = torch.argsort(key, stable=True)
    cells, counts = torch.unique_consecutive(key[order], return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    cap = max(1, min(int(counts.max()), ROW_CAP))
    crowded = counts > cap
    # Row c of ``table`` lists the particles of cell ``cells[c]`` (none
    # for a crowded cell), padded with n; the last row stands for an
    # empty cell.
    table = torch.full((cells.shape[0] + 1, cap), n, dtype=torch.int64,
                       device=dev)
    rank = torch.arange(n, device=dev) - starts.repeat_interleave(counts)
    cell_of = torch.arange(cells.shape[0], device=dev).repeat_interleave(
        counts)
    keep = ~crowded[cell_of]
    table[cell_of[keep], rank[keep]] = order[keep]
    pos_pad = torch.cat([pos, torch.full((1, 3), float("inf"),
                                         dtype=pos.dtype, device=dev)])
    offsets = torch.tensor([(a * dims[1] + b) * dims[2] + c
                            for a in (-1, 0, 1) for b in (-1, 0, 1)
                            for c in (-1, 0, 1)], device=dev)
    r2 = r * r
    chunk = max(1, BLOCK // (27 * cap))
    for s in range(0, n, chunk):
        i = torch.arange(s, min(s + chunk, n), device=dev)
        nb = key[i, None] + offsets[None, :]
        at = torch.searchsorted(cells, nb).clamp(max=cells.shape[0] - 1)
        row = torch.where(cells[at] == nb, at, cells.shape[0])
        cand = table[row].reshape(i.shape[0], -1)
        d = pos[i, None, :] - pos_pad[cand]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
        d2 = d2 + d[..., 2] * d[..., 2]
        hit = (d2 < r2) & (cand != i[:, None]) & (cand < n)
        best[i] = torch.where(hit, cand, NO_PARTNER).amin(dim=1)
    for c in torch.nonzero(crowded).flatten().tolist():
        members = order[starts[c]:starts[c] + counts[c]]
        nb = cells[c] + offsets
        at = torch.searchsorted(cells, nb).clamp(max=cells.shape[0] - 1)
        found = at[cells[at] == nb].tolist()
        near = torch.cat([order[starts[k]:starts[k] + counts[k]]
                          for k in found])
        rows = max(1, BLOCK // near.shape[0])
        col_best = torch.full_like(near, NO_PARTNER)
        for s in range(0, members.shape[0], rows):
            p = members[s:s + rows]
            # The gap is the same either way round: a - b is -(b - a).
            hit = (_d2(pos[p], pos[near]) < r2) & (p[:, None] != near[None])
            best[p] = torch.minimum(best[p], torch.where(
                hit, near[None], NO_PARTNER).amin(dim=1))
            col_best = torch.minimum(col_best, torch.where(
                hit, p[:, None], NO_PARTNER).amin(dim=0))
        best.scatter_reduce_(0, near, col_best, reduce="amin")
    return torch.where(best < NO_PARTNER, best, -1)


def _dot(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def resolve_pairs(S, partner, cr):
    """Mutual partners that overlap and approach collide: rewind both by
    the larger root t of |dx - dv t|^2 = cr^2, exchange the impulse along
    the contact normal, replay t.  Returns the pairs resolved."""
    n = S["pos"].shape[0]
    pos, vel = S["pos"], S["vel"]
    idx = torch.arange(n, device=pos.device)
    has = partner >= 0
    sp = torch.where(has, partner, 0)
    mutual = has & (partner[sp] == idx)
    pos_b, vel_b = pos[sp], vel[sp]
    dx, dv = pos_b - pos, vel - vel_b
    a = _dot(dv, dv)
    b = 2.0 * _dot(dx, dv)
    c = _dot(dx, dx) - cr * cr
    disc = b * b - 4.0 * a * c
    ok = mutual & (a > 0.0) & (disc >= 0.0) & (c < 0.0)
    sq = W.sqrt(torch.clamp(disc, min=0.0))
    a_safe = torch.where(a == 0.0, torch.ones_like(a), a)
    t = torch.maximum((-b + sq) / (2.0 * a_safe), (-b - sq) / (2.0 * a_safe))
    qa = pos - vel * t[:, None]
    qb = pos_b - vel_b * t[:, None]
    normal = W.div(qb - qa, cr)
    new_vel = vel - _dot(dv, normal)[:, None] * normal
    new_pos = qa + new_vel * t[:, None]
    W.record_completed(S, vel, t, ok)
    W.end_paths(S, ok, t, new_vel, zero_residual=False)
    S["pos"] = torch.where(ok[:, None], new_pos, pos)
    S["vel"] = torch.where(ok[:, None], new_vel, vel)
    return torch.sum(ok, dtype=torch.int32) // 2


def flush(S, M, setup):
    """Fold every staged path into the sums, the count and the histogram
    (floor(v / bin width), the last bin for all beyond), and clear it."""
    staged = S["staged"]
    vals = S["vals"][staged]
    width = setup.hist_hi / setup.num_bins
    ids = torch.clamp(torch.floor(W.div(vals, width)).to(torch.int64), 0,
                      setup.num_bins)
    flat = (ids + torch.arange(4, device=ids.device) * (setup.num_bins + 1))
    M["hist"] += torch.bincount(flat.flatten(), minlength=4 * (
        setup.num_bins + 1)).view(4, -1).double()
    M["path_sum"] += vals.double().sum(dim=0)
    M["path_count"] += int(staged.sum())
    S["vals"] = torch.zeros_like(S["vals"])
    S["staged"] = torch.zeros_like(staged)


def step(S, M, uniforms, setup):
    """One step; returns its ledger row (momentum_z, energy_hot,
    energy_cold, collisions): pair collisions plus wall hits."""
    dt = setup.dt
    prior = S["pos"]
    S["paths"] = S["paths"] + dt * W.path_components(S["vel"])
    S["pos"] = S["pos"] + dt * S["vel"]
    walls = kind(setup.kind)
    mom, e_h, e_c, hits = walls.walls(S, prior, uniforms, setup)
    pairs = resolve_pairs(S, lowest_partner(S["pos"], setup.cr), setup.cr)
    walls.after_collisions(S, setup)
    flush(S, M, setup)
    return [float(mom), float(e_h), float(e_c), int(pairs) + int(hits)]


def run(setup: Setup, seed: int, steps: int, device, dtype=torch.float32):
    """The reference's first ``steps`` steps from ``seed``: (state dict,
    accumulators, per-step ledger rows)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    S = {k: (v.to(dtype) if v.is_floating_point() else v)
         for k, v in draw_initial(setup, gen, device).items()}
    n = setup.n
    S["vals"] = torch.zeros((n, 4), dtype=dtype, device=device)
    S["staged"] = torch.zeros(n, dtype=torch.bool, device=device)
    M = dict(hist=torch.zeros((4, setup.num_bins + 1), dtype=torch.float64,
                              device=device),
             path_sum=torch.zeros(4, dtype=torch.float64, device=device),
             path_count=0)
    rows = []
    for _ in range(steps):
        u = torch.rand((n, 2), generator=gen, dtype=torch.float32,
                       device=device).to(dtype)
        rows.append(step(S, M, u, setup))
    return S, M, rows
