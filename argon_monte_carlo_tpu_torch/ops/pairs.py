"""Verlet reach-pair narrow phase: the neighbour sweep amortised over K steps.

Port of ``argon_monte_carlo_tpu.ops.pairs`` (ops/pairs.py:73-709).  Every
``rebuild_interval`` (K) steps the rebuild gives particle i the reach
``cr/2 + |v_i| K dt`` and lists every pair within ``reach_i + reach_j``
(K2 binning, then K1's half-shell sweep, then K5's emission); each step
tests only the listed pairs at the collision range (K3), and re-searches
the particles whose displacement bound broke this step against the
rebuild-time planes (K4), appending what they find.  The reference's
module docstring gives the coverage argument; the port keeps its
semantics, including the one-step latency classes it counts.

The rebuild-time planes are int32 and float tensors of their own --
``pos0`` (rows, cap, 3), ``idx0`` (rows, cap; the K2 table itself) and
``reach0`` (rows, cap) -- where the reference packs five float planes into
``mega0``; no integer rides in a float.

``PairList.age`` is carried as the reference carries it: set to INT_BIG
when the re-search loses coverage, and read by nothing.  The engine
rebuilds on the window schedule alone, as the reference's does.

Each kernel wrapper (``emit_pairs`` K5, ``test_and_resolve`` K3,
``research_dirty`` K4) runs its plain PyTorch twin (``*_plain``, same
signature and outputs) for CPU tensors and launches the CUDA kernel for
CUDA tensors.  K3 and K4, and their twins, update the step's own tensors
in place (the state and staging, the pair list) and return them: a
caller that needs its inputs afterwards passes copies.  K5 writes a fresh
list: the rebuild leaves the old one to whoever still holds it.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import kernels
from ..state import Measurements, ParticleState
from . import collide
from . import fp
from . import measure as measure_ops
from .compact import compact_indices_plain, lookback_scratch, stream_scratch

INT_BIG = 1 << 30
# Particles a block of K5 takes (compact.cu kEmitTile).
EMIT_TILE = 4096
# Entries a block of K3's test takes (test_resolve.cu kTile).
K3_TILE = 1024
# K3's scratch besides the look-back words it shares with K6, one a (device
# index, stream handle): the choice (int32, INT_BIG between calls) and the
# kept events (their count, a and b).
_K3_CHOICE: dict = {}
_K3_EVENTS: dict = {}


@dataclasses.dataclass(frozen=True)
class PairConfig:
    """Static capacities (host ints)."""

    rebuild_interval: int      # K
    pair_capacity: int         # M_cap: main emission + appended research
    event_capacity: int        # per-step colliding-entry compaction width
    research_capacity: int     # dirty particles re-searched per step
    research_top_k: int        # candidates kept per re-searched particle
    append_capacity: int       # research pair entries appended per step
    top_k: int                 # candidates kept per particle at rebuild


@dataclasses.dataclass
class PairList:
    """The Verlet pair state carried from step to step.

    a, b: (M_cap,) int32 entries, sentinel n = inert; cursor: () next
    append slot; age: () steps since the rebuild (INT_BIG = coverage lost;
    read by nothing, as in the reference); pos0 / idx0 / reach0: the
    rebuild-time slot planes; pslot0: (N,) rebuild-time particle -> slot;
    hot: (N,) re-search every step; pending1: (N,) one-shot re-search of
    full rebuild emissions; overflow / spill: () counters the engine folds
    into the measurements every step.
    """

    a: torch.Tensor
    b: torch.Tensor
    cursor: torch.Tensor
    age: torch.Tensor
    pos0: torch.Tensor
    idx0: torch.Tensor
    reach0: torch.Tensor
    pslot0: torch.Tensor
    hot: torch.Tensor
    pending1: torch.Tensor
    overflow: torch.Tensor
    spill: torch.Tensor

    @staticmethod
    def init(n: int, grid: collide.DeviceGrid, pcfg: PairConfig, dtype,
             device) -> "PairList":
        """An empty list whose age forces the first rebuild."""
        rows, cap = grid.num_cells + 1, grid.capacity

        def i32(value, *shape):
            return torch.full(shape, value, dtype=torch.int32, device=device)

        return PairList(
            a=i32(n, pcfg.pair_capacity), b=i32(n, pcfg.pair_capacity),
            cursor=i32(0), age=i32(INT_BIG),
            pos0=torch.zeros((rows, cap, 3), dtype=dtype, device=device),
            idx0=i32(n, rows, cap),
            reach0=torch.zeros((rows, cap), dtype=dtype, device=device),
            pslot0=i32(0, n),
            hot=torch.zeros(n, dtype=torch.bool, device=device),
            pending1=torch.zeros(n, dtype=torch.bool, device=device),
            overflow=i32(0), spill=i32(0),
        )


def default_pair_config(n: int, rebuild_interval: int,
                        pair_expectation: float | None = None,
                        spill_hot: int = 0) -> PairConfig:
    """Capacity heuristics at ambient argon density (pairs.py:615-709).

    ``pair_expectation`` is the expected in-reach candidate count per
    particle at rebuild, lambda(K); the emission tail is modelled as
    3.5 x P[Poisson(lambda) >= k] (the reference's calibration against a
    10M measurement), top_k grows until the expected full emissions fit a
    quarter of the re-search budget, and the append and pair budgets cover
    the burst that remains.
    """
    lam = 0.5 if pair_expectation is None else pair_expectation
    overdisp = 3.5
    research = max(4096, n // 256)
    top_k = 3

    def tail(k):  # overdisp * P[Poisson(lam) >= k]
        p = math.exp(-lam)
        cdf = p
        for i in range(1, k):
            p *= lam / i
            cdf += p
        return overdisp * max(1.0 - cdf, 0.0)

    while top_k < 12 and n * tail(top_k + 1) > research / 4:
        top_k += 1
    burst = int(n * tail(top_k + 1)) + 64
    research = max(research, 4 * burst)
    if spill_hot >= 256:
        research = research + spill_hot
    append = 2 * research + 12 * burst
    if pair_expectation is None:
        main = n // 4
    else:
        main = int(n * pair_expectation * 0.75)
    return PairConfig(
        rebuild_interval=rebuild_interval,
        pair_capacity=max(main, n // 4, 4096) + rebuild_interval * append,
        event_capacity=max(8192, n // 256),
        research_capacity=research,
        research_top_k=12,
        append_capacity=append,
        top_k=top_k,
    )


def reach_radii(vel: torch.Tensor, cr: float, dt: float, k_steps: int,
                max_reach: float):
    """(reach (N,), clipped (N,) bool): reach_i = cr/2 + |v_i| K dt,
    clipped at ``max_reach`` (pairs.py:135-140)."""
    raw = 0.5 * cr + measure_ops.speed(vel) * (dt * k_steps)
    return torch.clamp(raw, max=max_reach), raw > max_reach


# --------------------------------------------------------------------------
# Rebuild: K2 + K1 + K5 (pairs.py:143-277)
# --------------------------------------------------------------------------


def rebuild(state: ParticleState, grid: collide.DeviceGrid, pcfg: PairConfig,
            cr: float, dt: float, old: PairList) -> PairList:
    """The full sweep at per-particle reach: a fresh pair list.  A particle
    dropped from a full cell, or binned into a cell off the active list,
    goes hot (re-searched with its fresh position every step) instead of
    being lost, and is counted in ``spill``."""
    reach, clipped = reach_radii(state.vel, cr, dt, pcfg.rebuild_interval,
                                 0.5 * grid.cell_size)
    _, table, pslot, cell_overflow = collide.bin_and_table(state.pos, grid)
    cands, unswept, pos0, reach0 = collide.rebuild_sweep(
        state.pos, reach, table, pslot, grid, pcfg.top_k)
    return rebuild_finish(cands, cell_overflow, pslot, table, pos0, reach0,
                          unswept, clipped, old, grid, pcfg)


def rebuild_finish(cands, cell_overflow, pslot0, idx0, pos0, reach0,
                   unswept, clipped, old: PairList,
                   grid: collide.DeviceGrid, pcfg: PairConfig) -> PairList:
    """Rebuild epilogue (pairs.py:208-277): candidate rows -> PairList."""
    a, b, cursor, hot, pending1, overflow, spill = emit_pairs(
        cands, pslot0, clipped, unswept, cell_overflow, old.overflow,
        old.spill, grid.num_cells * grid.capacity, pcfg.pair_capacity)
    return PairList(
        a=a, b=b, cursor=cursor,
        age=torch.zeros((), dtype=torch.int32, device=a.device),
        pos0=pos0, idx0=idx0, reach0=reach0, pslot0=pslot0, hot=hot,
        pending1=pending1, overflow=overflow, spill=spill,
    )


def emit_pairs_plain(cands, pslot0, clipped, unswept, cell_overflow,
                     old_overflow, old_spill, dummy_slot: int, m_cap: int):
    """Plain version of K5: (a, b, cursor, hot, pending1, overflow, spill).

    Entries (i, c) for every candidate, particle-major and ascending within
    a particle, the first ``m_cap`` kept (the reference's two-stage
    compaction: the particles with any candidate, then their entries);
    ``overflow`` grows by the reference's own formula
    max(count - m_cap, 0) + max(has - m_cap, 0).  hot = clipped |
    table-dropped | unswept; pending1 marks a full top_k row.
    """
    n, top_k = cands.shape
    valid = cands >= 0
    has = valid.any(dim=1)
    pidx = compact_indices_plain(has, m_cap, n)
    p_ok = pidx < n
    p_safe = torch.where(p_ok, pidx, 0).long()
    pv = valid[p_safe] & p_ok[:, None]
    pc = cands[p_safe]
    mk = m_cap * top_k
    sel = compact_indices_plain(pv.reshape(-1), m_cap, mk)
    ok = sel < mk
    sel_safe = torch.where(ok, sel, 0).long()
    a = torch.where(ok, pidx[sel_safe // top_k], n).to(torch.int32)
    b = torch.where(ok, pc.reshape(-1)[sel_safe], n).to(torch.int32)
    count = torch.sum(valid, dtype=torch.int32)
    n_has = torch.sum(has, dtype=torch.int32)
    dropped = (torch.clamp(count - m_cap, min=0)
               + torch.clamp(n_has - m_cap, min=0))
    hot = clipped | (pslot0 >= dummy_slot) | unswept
    spill = old_spill + cell_overflow + torch.sum(unswept, dtype=torch.int32)
    return (a, b, torch.clamp(count, max=m_cap), hot, cands[:, -1] >= 0,
            old_overflow + dropped, spill)


def emit_pairs(cands, pslot0, clipped, unswept, cell_overflow, old_overflow,
               old_spill, dummy_slot: int, m_cap: int):
    """K5 (see ``emit_pairs_plain``); CUDA kernel for CUDA tensors: one
    single-pass launch (the entries' scan on ``lookback.cuh``, which gives
    the reference's list even when truncated: the first m_cap entries come
    from at most m_cap particles; the pad by extra blocks of the same
    grid).  Four allocations, the outputs (a and b share one); the
    look-back scratch is K6's, kept for each stream of each device and
    left zero by the kernel, so as with K6 a launch replays in a CUDA graph
    after one call on the capturing stream.  ``top_k`` is 1 to 16."""
    if kernels.use_plain(cands):
        return emit_pairs_plain(cands, pslot0, clipped, unswept,
                                cell_overflow, old_overflow, old_spill,
                                dummy_slot, m_cap)
    dev = cands.device
    n, top_k = cands.shape
    i32, b8 = torch.int32, torch.bool
    if not 1 <= top_k <= 16:
        raise ValueError(f"top_k={top_k}: the kernel takes 1 to 16")
    if n * top_k >= 1 << 31:
        raise ValueError(f"{n} x {top_k} candidates: the kernel counts "
                         f"entries in 31 bits")
    kernels.check(cands, "cands", i32, (n, top_k), dev)
    kernels.check(pslot0, "pslot0", i32, (n,), dev)
    kernels.check(clipped, "clipped", b8, (n,), dev)
    kernels.check(unswept, "unswept", b8, (n,), dev)
    for t, name in ((cell_overflow, "cell_overflow"),
                    (old_overflow, "old_overflow"), (old_spill, "old_spill")):
        kernels.check(t, name, i32, (), dev)
    ab = torch.empty((2, m_cap), dtype=i32, device=dev)
    counters = torch.empty(3, dtype=i32, device=dev)  # cursor, overflow, spill
    hot = torch.empty(n, dtype=b8, device=dev)
    pending1 = torch.empty(n, dtype=b8, device=dev)
    # The look-back words of the tiles and one word for the unswept count.
    scan = lookback_scratch(dev, max(-(-n // EMIT_TILE), 1) + 1)
    p = kernels.ptr
    kernels.launch(
        "emit_pairs", dev, p(cands), n, top_k, p(pslot0), dummy_slot,
        p(clipped), p(unswept), p(cell_overflow), p(old_overflow),
        p(old_spill), m_cap, p(ab[0]), p(ab[1]), p(counters[0]), p(hot),
        p(pending1), p(counters[1]), p(counters[2]), p(scan), scan.shape[0],
    )
    return ab[0], ab[1], counters[0], hot, pending1, counters[1], counters[2]


# --------------------------------------------------------------------------
# K3: the per-step narrow phase on the listed pairs (pairs.py:282-430)
# --------------------------------------------------------------------------


def test_and_resolve_plain(state: ParticleState, measure: Measurements,
                           a: torch.Tensor, b: torch.Tensor, cr: float,
                           event_capacity: int):
    """Plain version of K3.  Returns (state, measure, n_collisions (),
    collided (N,) bool); ``state``'s four tensors and ``measure``'s
    ``pending_vals``, ``pending_mask``, ``collision_count`` and
    ``overflow_count`` (colliding entries beyond ``event_capacity``) are
    updated in place and returned, as the kernel does.

    Every entry is tested at d^2 < cr^2 on the current positions (sentinel
    entries never collide); the colliding ones are compacted; each particle
    chooses its lowest-index colliding partner, and a mutual pair that
    approaches is rewound, exchanges the impulse and replays (the same
    maths and order as K10).  Duplicate and reversed entries write
    identical values.  Completed paths are staged with the pre-collision
    velocity and path accumulators reset along the new velocity.
    """
    n = state.pos.shape[0]
    m = a.shape[0]
    pos, vel = state.pos, state.vel
    dev = pos.device
    far = torch.full((1, 3), 1e9, dtype=pos.dtype, device=dev)
    pos_pad = torch.cat([pos, far])
    dxv = pos_pad[b.long()] - pos_pad[a.long()]
    colliding = (collide._dot3(dxv, dxv) < cr * cr) & (a < n)

    eidx = compact_indices_plain(colliding, event_capacity, m)
    evalid = eidx < m
    safe_e = torch.where(evalid, eidx, 0).long()
    ea = torch.where(evalid, a[safe_e], n)
    eb = torch.where(evalid, b[safe_e], n)
    ev_dropped = torch.clamp(
        torch.sum(colliding, dtype=torch.int32) - event_capacity, min=0)

    big = torch.full((), INT_BIG, dtype=torch.int32, device=dev)
    choice = torch.full((n + 1,), INT_BIG, dtype=torch.int32, device=dev)
    choice.scatter_reduce_(0, ea.long(), torch.where(evalid, eb, big),
                           "amin")
    choice.scatter_reduce_(0, eb.long(), torch.where(evalid, ea, big),
                           "amin")
    mutual = evalid & (choice[ea.long()] == eb) & (choice[eb.long()] == ea)

    sa = torch.clamp(ea, max=n - 1).long()
    sb = torch.clamp(eb, max=n - 1).long()
    pos_a, vel_a, pos_b, vel_b = pos[sa], vel[sa], pos[sb], vel[sb]
    dx = pos_b - pos_a
    dv = vel_a - vel_b
    aa = collide._dot3(dv, dv)
    bb = 2.0 * collide._dot3(dx, dv)
    cc = collide._dot3(dx, dx) - cr * cr
    disc = bb * bb - 4.0 * aa * cc
    ok = mutual & (aa > 0.0) & (disc >= 0.0) & (cc < 0.0)
    sq = fp.sqrt(torch.clamp(disc, min=0.0))
    a_safe = torch.where(aa == 0.0, torch.ones_like(aa), aa)
    t = torch.maximum((-bb + sq) / (2.0 * a_safe), (-bb - sq) / (2.0 * a_safe))
    qa = pos_a - vel_a * t[:, None]
    qb = pos_b - vel_b * t[:, None]
    normal = fp.div(qb - qa, cr)
    p_scal = collide._dot3(dv, normal)
    new_vel_a = vel_a - p_scal[:, None] * normal
    new_vel_b = vel_b + p_scal[:, None] * normal
    new_pos_a = qa + new_vel_a * t[:, None]
    new_pos_b = qb + new_vel_b * t[:, None]

    ia, ib = sa[ok], sb[ok]
    mask_n = torch.zeros(n, dtype=torch.bool, device=dev)
    mask_n[ia] = True
    mask_n[ib] = True
    t_n = torch.zeros(n, dtype=pos.dtype, device=dev)
    t_n[ia] = t[ok]
    t_n[ib] = t[ok]

    staged = measure_ops.record_completed(
        measure, state.paths, state.has_collided, vel, t_n, mask_n)
    vel_out = vel.clone()
    vel_out[ia], vel_out[ib] = new_vel_a[ok], new_vel_b[ok]
    ended = measure_ops.end_paths(state, mask_n, t_n, vel_out,
                                  zero_residual=False)
    n_collisions = torch.sum(mask_n, dtype=torch.int32) // 2
    # In place, once everything is computed from the inputs.
    pos[ia], pos[ib] = new_pos_a[ok], new_pos_b[ok]
    vel.copy_(vel_out)
    state.paths.copy_(ended.paths)
    state.has_collided.copy_(ended.has_collided)
    measure.pending_vals.copy_(staged.pending_vals)
    measure.pending_mask.copy_(staged.pending_mask)
    measure.collision_count.add_(n_collisions)
    measure.overflow_count.add_(ev_dropped)
    return state, measure, n_collisions, mask_n


def test_and_resolve(state: ParticleState, measure: Measurements,
                     a: torch.Tensor, b: torch.Tensor, cr: float,
                     event_capacity: int):
    """K3 (see ``test_and_resolve_plain``); CUDA kernels for CUDA tensors,
    three launches in one call: the test with the compaction and the
    choice, the resolve with the staging, and the reset of the choice
    scratch.  In place like the twin; the only allocations are the
    ``collided`` mask and ``n_collisions``.  The scratch is kept for each
    stream of each device and restored by the kernels (the look-back
    words are K6's, ``ops/compact.lookback_scratch``); as with K6, make
    one call on a stream before recording one in a CUDA graph there."""
    pos = state.pos
    if kernels.use_plain(pos):
        return test_and_resolve_plain(state, measure, a, b, cr,
                                      event_capacity)
    dev = pos.device
    n, m = pos.shape[0], a.shape[0]
    f32, b8, i32 = torch.float32, torch.bool, torch.int32
    inputs = [
        (pos, "pos", f32, (n, 3)), (state.vel, "vel", f32, (n, 3)),
        (state.paths, "paths", f32, (n, 4)),
        (state.has_collided, "has_collided", b8, (n,)),
        (measure.pending_vals, "pending_vals", f32, (n, 4)),
        (measure.pending_mask, "pending_mask", b8, (n,)),
        (measure.collision_count, "collision_count", i32, ()),
        (measure.overflow_count, "overflow_count", i32, ()),
        (a, "a", i32, (m,)), (b, "b", i32, (m,)),
    ]
    for t, name, dt, shape in inputs:
        kernels.check(t, name, dt, shape, dev)
    collided = torch.empty(n, dtype=b8, device=dev)
    n_collisions = torch.empty((), dtype=i32, device=dev)
    scan = lookback_scratch(dev, -(-m // K3_TILE))
    choice = stream_scratch(_K3_CHOICE, dev, n, i32, INT_BIG)
    events = stream_scratch(_K3_EVENTS, dev, 1 + 2 * event_capacity, i32, 0)
    p = kernels.ptr
    kernels.launch(
        "test_and_resolve", dev, *(p(t) for t, *_ in inputs), n, m,
        event_capacity, cr, cr * cr, p(collided), p(n_collisions), p(scan),
        p(choice), p(events),
    )
    return state, measure, n_collisions, collided


# --------------------------------------------------------------------------
# K4: the dirty re-search (pairs.py:433-612)
# --------------------------------------------------------------------------


def research_dirty_plain(state: ParticleState, plist: PairList,
                         dirty_idx: torch.Tensor, bump: torch.Tensor,
                         grid: collide.DeviceGrid, pcfg: PairConfig,
                         cr: float, dt: float):
    """Plain version of K4.  Returns (plist, lost () bool, latent_per (E,)
    int32).

    The list's ``reach0``, ``hot``, ``a`` and ``b`` are updated in place
    and returned in the new list (with a new ``cursor`` and ``overflow``),
    as the kernels do: a caller that reads the old list again passes one
    with copies of those four.

    ``dirty_idx`` (E,) lists particles, n = padding.  First every
    speed-changed (``bump``) listed particle's stored reach grows in place
    by its new window allowance |v| K dt, clipped at half a cell (a clip
    goes hot, as does a particle whose own reach clips); only then does
    each listed particle, binned at its current position, search the 27
    neighbour rows of the rebuild-time planes at reach_i + reach0_j.  The
    ``research_top_k`` lowest indices are appended at the cursor as (i, j)
    entries.  ``latent_per`` counts hits already within cr; ``lost`` says
    a candidate row filled, the appends overflowed or the list did.
    Padded lanes and particles without a rebuild slot write nothing (the
    reference writes them into particle 0 and the dummy row, which nothing
    reads back).
    """
    n = state.pos.shape[0]
    cap = grid.capacity
    e = dirty_idx.shape[0]
    rk = pcfg.research_top_k
    dev = state.pos.device
    max_reach = 0.5 * grid.cell_size
    valid = dirty_idx < n
    safe = torch.where(valid, dirty_idx, 0).long()
    pos_i, vel_i = state.pos[safe], state.vel[safe]
    reach_i, clipped_i = reach_radii(vel_i, cr, dt, pcfg.rebuild_interval,
                                     max_reach)
    unbounded = torch.sum(
        valid & (measure_ops.speed(vel_i) * dt > max_reach - 0.5 * cr),
        dtype=torch.int32)

    # In-place reach bumps, all of them before any search.
    slot = plist.pslot0[safe].long()
    bump_i = valid & bump[safe] & (slot < grid.num_cells * cap)
    reach0 = plist.reach0
    flat = reach0.view(-1)
    grown = flat[slot[bump_i]] + (reach_i[bump_i] - 0.5 * cr)
    flat[slot[bump_i]] = torch.clamp(grown, max=max_reach)
    newly = torch.zeros_like(valid)
    newly[bump_i] = grown > max_reach
    hot = plist.hot
    hot[safe[valid & (clipped_i | newly)]] = True

    # Search the 27 neighbour rows of the current cell.
    cell = collide.assign_cells_plain(pos_i, grid).long()
    rows = grid.neighbors[cell].long()                       # (E, 27)
    idx = plist.idx0[rows].reshape(e, 27 * cap)
    d = pos_i[:, None, :] - plist.pos0[rows].reshape(e, 27 * cap, 3)
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    d2 = d2 + d[..., 2] * d[..., 2]
    th = reach_i[:, None] + reach0[rows].reshape(e, 27 * cap)
    hit = ((d2 < th * th) & (idx != dirty_idx[:, None]) & valid[:, None]
           & (idx >= 0) & (idx < n))
    latent_per = torch.sum(hit & (d2 < cr * cr), dim=1, dtype=torch.int32)
    masked = torch.where(hit, idx, INT_BIG)
    cands = torch.sort(masked, dim=1).values[:, :rk]
    res_overflow = torch.sum((cands[:, -1] < INT_BIG) & valid,
                             dtype=torch.int32)

    # Append (i, c) at the cursor in compaction order.
    found = (cands < INT_BIG).reshape(-1)
    erk = e * rk
    sel = compact_indices_plain(found, pcfg.append_capacity, erk)
    sel_ok = sel < erk
    sel_safe = torch.where(sel_ok, sel, 0).long()
    new_a = torch.where(sel_ok, dirty_idx[sel_safe // rk], n)
    new_b = torch.where(sel_ok, cands.reshape(-1)[sel_safe], n)
    total = torch.sum(found, dtype=torch.int32)
    n_new = torch.clamp(total, max=pcfg.append_capacity)
    app_dropped = torch.clamp(total - pcfg.append_capacity, min=0)
    m_cap = plist.a.shape[0]
    lane = torch.arange(pcfg.append_capacity, dtype=torch.int32, device=dev)
    write_pos = plist.cursor + lane
    in_cap = (write_pos < m_cap) & (lane < n_new)
    a, b = plist.a, plist.b
    a[write_pos[in_cap].long()] = new_a[in_cap].to(torch.int32)
    b[write_pos[in_cap].long()] = new_b[in_cap].to(torch.int32)
    cap_dropped = torch.sum((lane < n_new) & ~in_cap, dtype=torch.int32)
    losses = res_overflow + app_dropped + cap_dropped
    plist = dataclasses.replace(
        plist, a=a, b=b, reach0=reach0, hot=hot,
        cursor=torch.clamp(plist.cursor + n_new, max=m_cap),
        overflow=plist.overflow + unbounded + losses)
    return plist, losses > 0, latent_per


def research_dirty(state: ParticleState, plist: PairList,
                   dirty_idx: torch.Tensor, bump: torch.Tensor,
                   grid: collide.DeviceGrid, pcfg: PairConfig, cr: float,
                   dt: float):
    """K4 (see ``research_dirty_plain``); CUDA kernels for CUDA tensors,
    three launches: the bumps, the search (a warp a dirty lane) and the
    append, so every bump lands before any search reads ``reach0``.  The
    kernels update the list's ``reach0``, ``hot``, ``a`` and ``b`` in
    place, as the twin does."""
    pos = state.pos
    if kernels.use_plain(pos):
        return research_dirty_plain(state, plist, dirty_idx, bump, grid,
                                    pcfg, cr, dt)
    dev = pos.device
    n = pos.shape[0]
    e = dirty_idx.shape[0]
    rk = pcfg.research_top_k
    cap = grid.capacity
    rows = grid.num_cells + 1
    m_cap = plist.a.shape[0]
    if not 1 <= rk <= 16:
        raise ValueError(f"research_top_k={rk}: the kernel keeps 1 to 16")
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    checks = [
        (pos, "pos", f32, (n, 3)), (state.vel, "vel", f32, (n, 3)),
        (dirty_idx, "dirty_idx", i32, (e,)), (bump, "bump", b8, (n,)),
        (plist.pslot0, "pslot0", i32, (n,)),
        (plist.pos0, "pos0", f32, (rows, cap, 3)),
        (plist.idx0, "idx0", i32, (rows, cap)),
        (plist.reach0, "reach0", f32, (rows, cap)),
        (plist.hot, "hot", b8, (n,)),
        (plist.a, "a", i32, (m_cap,)), (plist.b, "b", i32, (m_cap,)),
        (plist.cursor, "cursor", i32, ()),
        (plist.overflow, "overflow", i32, ()),
        (grid.neighbors, "grid.neighbors", i32, (grid.num_cells, 27)),
        (grid.nx, "grid.nx", i32, (grid.nz,)),
        (grid.layer_base, "grid.layer_base", i32, (grid.nz,)),
        (grid.half_extent, "grid.half_extent", f32, (grid.nz,)),
    ]
    for t, name, dt_, shape in checks:
        kernels.check(t, name, dt_, shape, dev)
    reach0, hot, a, b = plist.reach0, plist.hot, plist.a, plist.b
    # One allocation: cursor, overflow, latent_per (e), then the scratch,
    # a word a lane (e) and the lanes' lists (e * rk).
    ints = torch.empty(2 + e * (2 + rk), dtype=i32, device=dev)
    latent_per = ints[2:2 + e]
    lost = torch.empty((), dtype=b8, device=dev)
    max_reach = 0.5 * grid.cell_size
    p = kernels.ptr
    kernels.launch(
        "research_dirty", dev, p(pos), p(state.vel), p(dirty_idx), e, n,
        p(bump), p(plist.pslot0), p(plist.pos0), p(plist.idx0),
        p(grid.neighbors), p(grid.nx), p(grid.layer_base),
        p(grid.half_extent), grid.nz, grid.z_lo, grid.cell_size,
        grid.num_cells, cap, rk, pcfg.append_capacity, m_cap, 0.5 * cr,
        dt * pcfg.rebuild_interval, max_reach, max_reach - 0.5 * cr, dt,
        cr * cr, p(plist.cursor), p(plist.overflow), p(reach0), p(hot), p(a),
        p(b), p(ints[0]), p(ints[1]), p(lost), p(latent_per),
        p(ints[2 + 2 * e:]), p(ints[2 + e:]),
    )
    plist = dataclasses.replace(plist, a=a, b=b, reach0=reach0, hot=hot,
                                cursor=ints[0], overflow=ints[1])
    return plist, lost, latent_per
