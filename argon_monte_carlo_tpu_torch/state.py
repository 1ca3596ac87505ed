"""Particle state and measurement accumulators as dataclasses of tensors.

Port of ``argon_monte_carlo_tpu.state``.  Struct-of-arrays layout:
``pos``/``vel`` are ``(N, 3)``, path accumulators ``(N, 4)`` in the axis
order (total, x, y, z).  The engine functions return new tensors and never
write into their inputs, as the JAX reference does (the step keeps the
pre-drift positions, ``prior``, by reference while the walls run), except
the pairs step's kernels K3, K4 and K7's compacted entry, which update the
step's own state, staging, counters and pair list in place;
``Simulation.run`` therefore carries copies of what its caller hands it.

Counters are 0-d int32 tensors on the state's device, so a run never has
to read them back to the host inside an epoch.
"""

from __future__ import annotations

import dataclasses

import torch

# Path component order used everywhere: total, x, y, z.
NUM_PATH_AXES = 4


@dataclasses.dataclass
class ParticleState:
    """pos, vel (N, 3); paths (N, 4) distance since the last collision;
    has_collided (N,) bool -- the first collision ends a partial path that
    is discarded (Open_Air_Cube_MC.py:139, 267-280)."""

    pos: torch.Tensor
    vel: torch.Tensor
    paths: torch.Tensor
    has_collided: torch.Tensor

    @property
    def num_particles(self) -> int:
        return self.pos.shape[0]

    @staticmethod
    def zeros(n: int, dtype=torch.float32, device="cpu") -> "ParticleState":
        return ParticleState(
            pos=torch.zeros((n, 3), dtype=dtype, device=device),
            vel=torch.zeros((n, 3), dtype=dtype, device=device),
            paths=torch.zeros((n, NUM_PATH_AXES), dtype=dtype, device=device),
            has_collided=torch.zeros((n,), dtype=torch.bool, device=device),
        )


def _count(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


@dataclasses.dataclass
class Measurements:
    """Device accumulators (reference state.Measurements).

    hist: (4, num_bins + 1) float32 binned completed free paths; the last
          bin collects values beyond ``hist_range``.
    path_sum / path_count: exact running sum and count of completed paths.
    collision_count: pair collisions plus wall hits.
    err_count: wall-solver degeneracies.
    overflow_count: particles dropped from over-capacity cells.
    hist_drop_count: events beyond the flush capacity, dropped from the
          histogram only (never from the sums).
    hot_spill_count: pairs engine only -- rebuild-time cell-table spills
          and strays in inactive cells, absorbed by the hot set (not a
          loss, so separate from overflow_count).
    halo_trunc_count: sharded engine only -- halo-band lanes that did not
          fit the halo buffer.  The particle stays on its owner; only its
          visibility to the neighbouring slab's pair search is lost, so it
          is kept apart from overflow_count (particles actually lost).
    pending_vals / pending_mask: per-particle staging of this step's
          completed paths, folded in by the histogram flush.  The sharded
          engine sizes it for a slab's local and ghost lanes together.
    """

    hist: torch.Tensor
    path_sum: torch.Tensor
    path_count: torch.Tensor
    collision_count: torch.Tensor
    err_count: torch.Tensor
    overflow_count: torch.Tensor
    hist_drop_count: torch.Tensor
    hot_spill_count: torch.Tensor
    halo_trunc_count: torch.Tensor
    pending_vals: torch.Tensor
    pending_mask: torch.Tensor

    @staticmethod
    def zeros(num_bins: int, dtype=torch.float32, num_particles: int = 0,
              device="cpu") -> "Measurements":
        return Measurements(
            hist=torch.zeros((NUM_PATH_AXES, num_bins + 1),
                             dtype=torch.float32, device=device),
            path_sum=torch.zeros((NUM_PATH_AXES,), dtype=dtype, device=device),
            path_count=_count(device),
            collision_count=_count(device),
            err_count=_count(device),
            overflow_count=_count(device),
            hist_drop_count=_count(device),
            hot_spill_count=_count(device),
            halo_trunc_count=_count(device),
            pending_vals=torch.zeros((num_particles, NUM_PATH_AXES),
                                     dtype=dtype, device=device),
            pending_mask=torch.zeros((num_particles,), dtype=torch.bool,
                                     device=device),
        )


@dataclasses.dataclass
class StepMetrics:
    """Per-step scalars; ``Simulation.run`` stacks them to (steps,) tensors.

    momentum_z / energy_hot / energy_cold are the reference's per-step
    ledger (Temperature_Pore_MC.py:685-687, 755-758).  missed_cases is
    (10,) int32 a step ((K, 10) stacked): the residual wall-case counts
    of the missed-case audit, zeros unless ``debug_audits`` is on
    (reference state.py:149-155).  The last five are
    the pairs engine's (zero in the sweep): whether the step began with a
    rebuild, how many particles were dirty, and the one-step-latency
    diagnostics -- full rebuild emissions consumed this step, recapture
    teleports, and re-searched candidates already within the collision
    range of their stored position (reference state.py:157-181).
    """

    momentum_z: torch.Tensor
    energy_hot: torch.Tensor
    energy_cold: torch.Tensor
    collisions: torch.Tensor
    wall_hits: torch.Tensor
    oob_after_walls: torch.Tensor
    oob_after_pairs: torch.Tensor
    missed_cases: torch.Tensor
    nonfinite: torch.Tensor
    rebuilt: torch.Tensor
    dirty_count: torch.Tensor
    latent_full: torch.Tensor
    teleports: torch.Tensor
    latent_research: torch.Tensor

    @staticmethod
    def stack(steps: list["StepMetrics"]) -> "StepMetrics":
        return StepMetrics(**{
            f.name: torch.stack([getattr(s, f.name) for s in steps])
            for f in dataclasses.fields(StepMetrics)
        })

    @staticmethod
    def concat(parts: list["StepMetrics"]) -> "StepMetrics":
        return StepMetrics(**{
            f.name: torch.cat([getattr(p, f.name) for p in parts])
            for f in dataclasses.fields(StepMetrics)
        })
