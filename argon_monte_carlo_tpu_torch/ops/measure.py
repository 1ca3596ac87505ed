"""Free-path measurement: the partial/full path state machine + histograms.

Port of ``argon_monte_carlo_tpu.ops.measure``.  Events stage their
completed path (total, x, y, z) into ``Measurements.pending_*``, one slot
per particle; ``flush_hist`` (K7) folds the staging into the exact running
sums and counts and the binned ``(4, num_bins+1)`` histogram once per flush.
The pairs engine flushes through ``flush_hist_compacted`` (K7's second
entry), which bins the events listed by the engine's shared compaction.
Both entries, and their twins, update the measurements in place.
A particle's first collision ends a partial path, which is discarded
(Open_Air_Cube_MC.py:267-280).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import kernels
from ..state import Measurements, ParticleState
from . import fp
from .compact import compact_indices_plain, lookback_scratch, stream_scratch

# Fixed event-compaction width of the flush (reference ops/measure.py:85).
# Above it only the lowest-index events are binned; the rest are counted in
# hist_drop_count and still enter the exact sums.
FLUSH_CAPACITY = 16384
# Particles a block of either entry takes (flush_hist.cu kFlushTile).
FLUSH_TILE = 4096
# K7's scratch, one a (device index, stream handle), shared by both entries:
# the ticket and the integer bins (int32, zero between calls), and the
# tiles' sums.
_FLUSH_INTS: dict = {}
_FLUSH_SUMS: dict = {}


def speed(vel: torch.Tensor) -> torch.Tensor:
    """(N,) |v| as sqrt((vx*vx + vy*vy) + vz*vz): the one speed formula of
    the port (the reference's jnp.linalg.norm), shared by the path
    bookkeeping, the reach radii and the pairs engine's bump mask, and
    computed in the same order by the kernels."""
    vx, vy, vz = vel[:, 0], vel[:, 1], vel[:, 2]
    return fp.sqrt(vx * vx + vy * vy + vz * vz)


def path_components(vel: torch.Tensor) -> torch.Tensor:
    """(N, 4) |velocity| magnitudes in path-axis order (total, x, y, z)."""
    return torch.stack([speed(vel), vel[:, 0].abs(), vel[:, 1].abs(),
                        vel[:, 2].abs()], dim=-1)


def accumulate_drift(state: ParticleState, dt: float) -> torch.Tensor:
    """Distance accrued during one drift (Open_Air_Cube_MC.py:184-187)."""
    return state.paths + dt * path_components(state.vel)


def record_completed(measure: Measurements, paths_before: torch.Tensor,
                     has_collided_before: torch.Tensor,
                     vel_before: torch.Tensor, t: torch.Tensor,
                     mask: torch.Tensor) -> Measurements:
    """Stage ``|path_k - |v_k| t|`` for masked particles whose partial path
    already ended (Open_Air_Cube_MC.py:267-272).  A staging area longer
    than the particle arrays (a slab's local and ghost lanes, measure.py:
    65-73) takes the events in its first rows and keeps the rest."""
    emit = mask & has_collided_before
    comps = torch.abs(paths_before - path_components(vel_before) * t[:, None])
    m = comps.shape[0]
    vals, staged = measure.pending_vals, measure.pending_mask
    new_vals = torch.where(emit[:, None], comps, vals[:m])
    new_mask = staged[:m] | emit
    if vals.shape[0] > m:
        new_vals = torch.cat([new_vals, vals[m:]])
        new_mask = torch.cat([new_mask, staged[m:]])
    return dataclasses.replace(measure, pending_vals=new_vals,
                               pending_mask=new_mask)


def end_paths(state: ParticleState, mask: torch.Tensor, t: torch.Tensor,
              vel_after: torch.Tensor, zero_residual: bool) -> ParticleState:
    """Reset path accumulators after a collision event: specular walls and
    pair collisions keep the overshoot |v'_k| t along the new direction,
    energized walls (particle placed on the wall) keep zero."""
    if zero_residual:
        residual = torch.zeros_like(state.paths)
    else:
        residual = torch.abs(path_components(vel_after) * t[:, None])
    return dataclasses.replace(
        state,
        paths=torch.where(mask[:, None], residual, state.paths),
        has_collided=state.has_collided | mask,
    )


# --------------------------------------------------------------------------
# K7: histogram flush (measure.py:131-197)
# --------------------------------------------------------------------------


def _bin_counts(vals: torch.Tensor, binned: torch.Tensor, num_bins: int,
                hist_hi: float) -> torch.Tensor:
    """(4, num_bins+1) float32 counts of the rows ``binned`` of ``vals``:
    floor(v / bin_width) clipped to [0, num_bins] per axis."""
    bin_width = hist_hi / num_bins
    ids = torch.clamp(
        torch.floor(fp.div(vals[binned], bin_width)).to(torch.int32), 0,
        num_bins)
    offsets = torch.arange(4, dtype=torch.int32, device=vals.device)
    flat = (ids + offsets * (num_bins + 1)).flatten().long()
    counts = torch.bincount(flat, minlength=4 * (num_bins + 1))
    return counts.view(4, num_bins + 1).to(torch.float32)


def _fold(measure: Measurements, counts: torch.Tensor,
          n_events: torch.Tensor, drop) -> Measurements:
    """The flush's in-place end: sums, counts and histogram updated, the
    staged rows cleared (an unstaged row is zero already)."""
    vals, mask = measure.pending_vals, measure.pending_mask
    staged_sum = torch.where(mask[:, None], vals,
                             torch.zeros_like(vals)).sum(dim=0)
    measure.hist.add_(counts)
    measure.path_sum.add_(staged_sum)
    measure.path_count.add_(n_events)
    measure.hist_drop_count.add_(drop)
    vals.masked_fill_(mask[:, None], 0.0)
    mask.zero_()
    return measure


def flush_hist_plain(measure: Measurements, num_bins: int, hist_hi: float,
                     capacity: int = FLUSH_CAPACITY) -> Measurements:
    """Plain version of K7's dense entry (measure.py:131-197): path_sum +=
    the staged rows, path_count += events, bin floor(v / bin_width)
    clipped to [0, num_bins] per axis, and clear the staging.  With more
    than ``capacity`` particles only the lowest-index ``capacity`` events
    are binned and the excess is added to ``hist_drop_count`` (the
    reference's compacted branch).  ``hist``, ``path_sum``, ``path_count``,
    ``hist_drop_count`` and the staging are updated in place and returned,
    as the kernel does; only the staged rows are cleared, under the
    staging's contract that a row whose mask is clear is zero (see
    ``flush_hist_compacted_plain``)."""
    vals, mask = measure.pending_vals, measure.pending_mask
    n = vals.shape[0]
    n_events = torch.sum(mask, dtype=torch.int32)
    drop = 0
    if n > capacity:
        event_idx = compact_indices_plain(mask, capacity, n)
        binned = event_idx[event_idx < n].long()
        drop = torch.clamp(n_events - capacity, min=0)
    else:
        binned = torch.nonzero(mask).flatten()
    counts = _bin_counts(vals, binned, num_bins, hist_hi)
    return _fold(measure, counts, n_events, drop)


def _flush_scratch(dev: torch.device, tiles: int, row: int):
    """K7's scratch of this stream, shared by both entries (each call
    leaves it as it found it): the ticket and the integer bins, the tiles'
    sums."""
    ints = stream_scratch(_FLUSH_INTS, dev, 1 + 4 * row, torch.int32, 0)
    sums = stream_scratch(_FLUSH_SUMS, dev, 4 * tiles, torch.float32, 0)
    return ints, sums


def _check_measure(measure: Measurements, num_bins: int, n: int,
                   dev: torch.device) -> None:
    row = num_bins + 1
    if 4 * row * 4 > 48 * 1024:
        raise ValueError(f"num_bins={num_bins}: the kernel's shared-memory "
                         f"bins hold at most {48 * 1024 // 16 - 1}")
    f32, i32 = torch.float32, torch.int32
    kernels.check(measure.pending_vals, "pending_vals", f32, (n, 4), dev)
    kernels.check(measure.pending_mask, "pending_mask", torch.bool, (n,), dev)
    kernels.check(measure.hist, "hist", f32, (4, row), dev)
    kernels.check(measure.path_sum, "path_sum", f32, (4,), dev)
    kernels.check(measure.path_count, "path_count", i32, (), dev)
    kernels.check(measure.hist_drop_count, "hist_drop_count", i32, (), dev)


def flush_hist(measure: Measurements, num_bins: int, hist_hi: float,
               capacity: int = FLUSH_CAPACITY) -> Measurements:
    """K7's dense entry (see ``flush_hist_plain``); CUDA kernel for CUDA
    tensors: one launch, in place, deterministic, no allocation.  Its
    scratch (a ticket, integer bins, the tiles' sums, and with more than
    ``capacity`` particles the look-back words) is kept for each stream of
    each device and restored by the kernel (see
    ``ops/compact.stream_scratch``); make one call on a stream before
    recording one in a CUDA graph there."""
    vals = measure.pending_vals
    if kernels.use_plain(vals):
        return flush_hist_plain(measure, num_bins, hist_hi, capacity)
    dev = vals.device
    n = vals.shape[0]
    _check_measure(measure, num_bins, n, dev)
    tiles = max(-(-n // FLUSH_TILE), 1)
    ints, sums = _flush_scratch(dev, tiles, num_bins + 1)
    scan = lookback_scratch(dev, tiles)
    p = kernels.ptr
    kernels.launch(
        "flush_hist", dev, p(vals), p(measure.pending_mask), n, capacity,
        num_bins, hist_hi / num_bins, p(measure.hist), p(measure.path_sum),
        p(measure.path_count), p(measure.hist_drop_count), p(ints), p(sums),
        p(scan),
    )
    return measure


def check_event_idx(event_idx: torch.Tensor, n: int) -> None:
    """Raise unless ``event_idx`` is ascending: strictly increasing
    particle indices in [0, n), then only the padding n (K6's output)."""
    idx = event_idx.long()
    if idx.numel() == 0:
        return
    prev, nxt = idx[:-1], idx[1:]
    ok = ((idx.min() >= 0) & (idx.max() <= n)
          & ((nxt > prev) | ((prev == n) & (nxt == n))).all())
    if not bool(ok):
        raise ValueError("event_idx must ascend: strictly increasing "
                         f"indices below n={n}, then the padding n")


def flush_hist_compacted_plain(measure: Measurements,
                               event_idx: torch.Tensor, num_bins: int,
                               hist_hi: float) -> Measurements:
    """Plain version of K7's compacted entry (measure.py:88-128): sums and
    counts over every staged event, the histogram over the staged events
    that ``event_idx`` lists (a superset is fine), the staged events it
    does not list added to ``hist_drop_count``, and the staged rows
    cleared.  ``hist``, ``path_sum``, ``path_count``, ``hist_drop_count``
    and the staging are updated in place and returned, as the kernel does.

    ``event_idx`` must ascend (``check_event_idx``; the engine's shared
    compaction does).  Only the staged rows are cleared: the staging keeps
    a row whose mask is clear at zero (every writer stages a row only
    where it sets the mask, and every flush clears what was staged), so
    the staging ends all zero, as the reference's does.
    """
    vals, mask = measure.pending_vals, measure.pending_mask
    n = vals.shape[0]
    check_event_idx(event_idx, n)
    n_events = torch.sum(mask, dtype=torch.int32)
    listed = event_idx[event_idx < n].long()
    binned = listed[mask[listed]]
    counts = _bin_counts(vals, binned, num_bins, hist_hi)
    return _fold(measure, counts, n_events, n_events - binned.shape[0])


def flush_hist_compacted(measure: Measurements, event_idx: torch.Tensor,
                         num_bins: int, hist_hi: float) -> Measurements:
    """K7's compacted entry (see ``flush_hist_compacted_plain``); CUDA
    kernel for CUDA tensors: one launch, in place, deterministic, no
    allocation.  Its scratch (a ticket, integer bins, the blocks' sums) is
    kept for each stream of each device and restored by the kernel (see
    ``ops/compact.stream_scratch``); make one call on a stream before
    recording one in a CUDA graph there.  ``event_idx`` is not checked
    here: the engine passes K6's output, which ascends."""
    vals = measure.pending_vals
    if kernels.use_plain(vals):
        return flush_hist_compacted_plain(measure, event_idx, num_bins,
                                          hist_hi)
    dev = vals.device
    n = vals.shape[0]
    e = event_idx.shape[0]
    _check_measure(measure, num_bins, n, dev)
    kernels.check(event_idx, "event_idx", torch.int32, (e,), dev)
    ints, sums = _flush_scratch(dev, max(-(-n // FLUSH_TILE), 1),
                                num_bins + 1)
    p = kernels.ptr
    kernels.launch(
        "flush_hist_compacted", dev, p(vals), p(measure.pending_mask), n,
        p(event_idx), e, num_bins, hist_hi / num_bins, p(measure.hist),
        p(measure.path_sum), p(measure.path_count),
        p(measure.hist_drop_count), p(ints), p(sums),
    )
    return measure
