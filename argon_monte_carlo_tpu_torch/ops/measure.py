"""Free-path measurement: the partial/full path state machine + histograms.

Port of ``argon_monte_carlo_tpu.ops.measure``.  Events stage their
completed path (total, x, y, z) into ``Measurements.pending_*``, one slot
per particle; ``flush_hist`` (K7) folds the staging into the exact running
sums and counts and the binned ``(4, num_bins+1)`` histogram once per flush.
A particle's first collision ends a partial path, which is discarded
(Open_Air_Cube_MC.py:267-280).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import kernels
from ..state import Measurements, ParticleState
from . import fp
from .compact import compact_indices

# Fixed event-compaction width of the flush (reference ops/measure.py:85).
# Above it only the lowest-index events are binned; the rest are counted in
# hist_drop_count and still enter the exact sums.
FLUSH_CAPACITY = 16384


def path_components(vel: torch.Tensor) -> torch.Tensor:
    """(N, 4) |velocity| magnitudes in path-axis order (total, x, y, z)."""
    vx, vy, vz = vel[:, 0], vel[:, 1], vel[:, 2]
    speed = fp.sqrt(vx * vx + vy * vy + vz * vz)
    return torch.stack([speed, vx.abs(), vy.abs(), vz.abs()], dim=-1)


def accumulate_drift(state: ParticleState, dt: float) -> torch.Tensor:
    """Distance accrued during one drift (Open_Air_Cube_MC.py:184-187)."""
    return state.paths + dt * path_components(state.vel)


def record_completed(measure: Measurements, paths_before: torch.Tensor,
                     has_collided_before: torch.Tensor,
                     vel_before: torch.Tensor, t: torch.Tensor,
                     mask: torch.Tensor) -> Measurements:
    """Stage ``|path_k - |v_k| t|`` for masked particles whose partial path
    already ended (Open_Air_Cube_MC.py:267-272)."""
    emit = mask & has_collided_before
    comps = torch.abs(paths_before - path_components(vel_before) * t[:, None])
    return dataclasses.replace(
        measure,
        pending_vals=torch.where(emit[:, None], comps, measure.pending_vals),
        pending_mask=measure.pending_mask | emit,
    )


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


def flush_hist_plain(measure: Measurements, num_bins: int, hist_hi: float,
                     capacity: int = FLUSH_CAPACITY) -> Measurements:
    """Plain version of K7: path_sum += masked staging, path_count +=
    events, bin floor(v / bin_width) clipped to [0, num_bins] per axis, and
    clear the staging.  With more than ``capacity`` particles only the
    lowest-index ``capacity`` events are binned and the excess is added to
    ``hist_drop_count`` (the reference's compacted branch)."""
    vals, mask = measure.pending_vals, measure.pending_mask
    n = vals.shape[0]
    path_sum = measure.path_sum + torch.where(
        mask[:, None], vals, torch.zeros_like(vals)).sum(dim=0)
    n_events = torch.sum(mask, dtype=torch.int32)
    drop = measure.hist_drop_count
    if n > capacity:
        event_idx = compact_indices(mask, capacity, n)
        binned = event_idx[event_idx < n].long()
        drop = drop + torch.clamp(n_events - capacity, min=0)
    else:
        binned = torch.nonzero(mask).flatten()
    bin_width = hist_hi / num_bins
    ids = torch.clamp(
        torch.floor(fp.div(vals[binned], bin_width)).to(torch.int32), 0,
        num_bins)
    offsets = torch.arange(4, dtype=torch.int32, device=vals.device)
    flat = (ids + offsets * (num_bins + 1)).flatten().long()
    counts = torch.bincount(flat, minlength=4 * (num_bins + 1))
    return dataclasses.replace(
        measure,
        hist=measure.hist + counts.view(4, num_bins + 1).to(torch.float32),
        path_sum=path_sum,
        path_count=measure.path_count + n_events,
        hist_drop_count=drop,
        pending_vals=torch.zeros_like(vals),
        pending_mask=torch.zeros_like(mask),
    )


def flush_hist(measure: Measurements, num_bins: int, hist_hi: float,
               capacity: int = FLUSH_CAPACITY) -> Measurements:
    """K7 (see ``flush_hist_plain``); CUDA kernel for CUDA tensors."""
    vals = measure.pending_vals
    if kernels.use_plain(vals):
        return flush_hist_plain(measure, num_bins, hist_hi, capacity)
    dev = vals.device
    n = vals.shape[0]
    row = num_bins + 1
    if 4 * row * 4 > 48 * 1024:
        raise ValueError(f"num_bins={num_bins}: the kernel's shared-memory "
                         f"bins hold at most {48 * 1024 // 16 - 1}")
    f32, i32 = torch.float32, torch.int32
    kernels.check(vals, "pending_vals", f32, (n, 4), dev)
    kernels.check(measure.pending_mask, "pending_mask", torch.bool, (n,), dev)
    kernels.check(measure.hist, "hist", f32, (4, row), dev)
    kernels.check(measure.path_sum, "path_sum", f32, (4,), dev)
    kernels.check(measure.path_count, "path_count", i32, (), dev)
    kernels.check(measure.hist_drop_count, "hist_drop_count", i32, (), dev)
    # In-place targets of the kernel: fresh copies, so inputs stay intact.
    hist = measure.hist.clone()
    path_sum = measure.path_sum.clone()
    path_count = measure.path_count.clone()
    drop = measure.hist_drop_count.clone()
    nblocks = -(-n // 256)
    block_sums = torch.empty((nblocks, 4), dtype=f32, device=dev)
    block_counts = torch.empty(nblocks, dtype=i32, device=dev)
    block_offsets = torch.empty(nblocks, dtype=i32, device=dev)
    bins = torch.empty(4 * row, dtype=i32, device=dev)
    vals_out = torch.empty_like(vals)
    mask_out = torch.empty_like(measure.pending_mask)
    p = kernels.ptr
    kernels.launch(
        "flush_hist", dev, p(vals), p(measure.pending_mask), n, capacity,
        num_bins, hist_hi / num_bins, p(hist), p(path_sum), p(path_count),
        p(drop), p(block_sums), p(block_counts), p(block_offsets), p(bins),
        p(vals_out), p(mask_out),
    )
    return dataclasses.replace(
        measure, hist=hist, path_sum=path_sum, path_count=path_count,
        hist_drop_count=drop, pending_vals=vals_out, pending_mask=mask_out,
    )
