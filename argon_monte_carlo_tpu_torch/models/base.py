"""Shared wall-case bookkeeping for the workload models (port of
``models/base.apply_tracked``; the missed-case audit is ROADMAP slice 7)."""

from __future__ import annotations

import torch

from ..ops import measure as measure_ops
from ..ops.walls import WallEvent
from ..state import Measurements, ParticleState


def apply_tracked(state: ParticleState, measure: Measurements,
                  event: WallEvent, case_mask: torch.Tensor,
                  paths_before: torch.Tensor, has_before: torch.Tensor,
                  zero_residual: bool):
    """Free-path bookkeeping and hit counting for one wall case.

    ``case_mask`` is the raw case predicate (every particle in the case,
    solver errors included, counts as a hit, Open_Air_Pore_MC.py:348);
    ``event.mask`` is the subset actually handled.
    Returns (state, measure, wall_hits).
    """
    measure = measure_ops.record_completed(
        measure, paths_before, has_before, event.vel_before, event.t,
        event.mask,
    )
    state = measure_ops.end_paths(state, event.mask, event.t, state.vel,
                                  zero_residual)
    return state, measure, torch.sum(case_mask, dtype=torch.int32)
