"""Workload and engine configuration for the PyTorch port.

Mirrors ``argon_monte_carlo_tpu.config`` for the temperature-pore workload.
``EngineConfig`` keeps only the knobs that change physics or shapes; the
reference's compile-wall and TPU lane-geometry knobs have no counterpart
here.  Options the port does not run yet raise ``NotImplementedError``
naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .geometry import PoreGeometry
from .physics import GasPhysics, PORE_PHYSICS, TEMPERATURE_PORE_PHYSICS
from .utils import debye

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Execution knobs of the sweep engine."""

    # "float32" (the card's working type) or "float64" (CPU parity tests).
    dtype: str = "float32"
    # Pair broad phase; only the cell grid is ported.
    broadphase: str = "cells"
    # Target mean particles per occupied cell (sets the cell size).
    cell_occupancy: float = 11.0
    # Slots per cell; None = auto from the occupancy Poisson tail.
    cell_capacity: Optional[int] = None
    # Steps per epoch: the host looks at results only between epochs.
    steps_per_epoch: int = 100
    # Free-path histograms (reference: 200 bins over (0, 1e-6)).
    num_bins: int = 200
    hist_range: tuple[float, float] = (0.0, 1e-6)
    # Narrow phase: the full 27-neighbourhood sweep every step.
    narrowphase: str = "sweep"
    # Must be 1 for the sweep (it re-sweeps every step).
    rebuild_interval: int = 1
    # Flush staged histogram events every N steps (1 = exact).
    hist_flush_interval: int = 1
    # Extra search radius beyond collision_range (metres).
    skin: float = 0.0
    # Count non-finite state elements per step.
    check_finite: bool = False
    # The reference's missed-case audit; not ported yet.
    debug_audits: bool = False

    def __post_init__(self):
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")
        if self.narrowphase == "pairs":
            raise NotImplementedError(
                "narrowphase='pairs' is not ported yet (ROADMAP queue 1, "
                "slices 3-5: the Verlet pair-list engine, K1 and K3-K6)"
            )
        if self.narrowphase != "sweep":
            raise ValueError(f"unknown narrowphase {self.narrowphase!r}")
        if self.broadphase == "allpairs":
            raise NotImplementedError(
                "broadphase='allpairs' is not ported yet (ROADMAP queue 1, "
                "slice 7: the cube and the all-pairs search, K11)"
            )
        if self.broadphase != "cells":
            raise ValueError(f"unknown broadphase {self.broadphase!r}")
        if self.debug_audits:
            raise NotImplementedError(
                "debug_audits is not ported yet (ROADMAP queue 1, slice 7: "
                "audits)"
            )
        if self.rebuild_interval != 1:
            raise ValueError(
                "rebuild_interval > 1 requires narrowphase='pairs' (the "
                "sweep rebuilds its cell structure every step)"
            )

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


@dataclasses.dataclass(frozen=True)
class PoreConfig:
    """Thruster pore.  Only ``energized=True`` (Temperature_Pore_MC) runs in
    the port; the specular pore is ROADMAP queue 1, slice 7."""

    geometry: PoreGeometry = PoreGeometry()
    energized: bool = False
    seed: int = 17
    nmft: int = 20
    steps_per_mft: int = 1000
    engine: EngineConfig = EngineConfig(broadphase="cells")
    num_particles_override: Optional[int] = None

    # Thermal-wall parameters (Temperature_Pore_MC.py:72-79).
    t_cold: float = 293.0
    t_hot: float = 353.0
    t_debye_graphene: float = debye.T_DEBYE_GRAPHENE
    t_debye_alumina: float = debye.T_DEBYE_ALUMINA
    coated_accommodation_coeff: float = debye.COATED_ACCOMMODATION_COEFF
    gap_accommodation_coeff: float = debye.GAP_ACCOMMODATION_COEFF
    cone_half_angle_deg: float = 85.0

    @property
    def physics(self) -> GasPhysics:
        return TEMPERATURE_PORE_PHYSICS if self.energized else PORE_PHYSICS

    @property
    def num_molecules(self) -> int:
        if self.num_particles_override is not None:
            return self.num_particles_override
        return self.physics.num_molecules(self.geometry.volume)

    @property
    def num_timesteps(self) -> int:
        return self.nmft * self.steps_per_mft

    @property
    def dt(self) -> float:
        return self.nmft * self.physics.tau / self.num_timesteps

    @property
    def surface_energy_cold(self) -> float:
        return float(
            debye.surface_energy(
                self.t_cold,
                self.t_debye_graphene,
                debye.NUM_ATOMS_UNITCELL_GRAPHENE,
                self.physics.boltzmann,
            )
        )

    @property
    def surface_energy_hot(self) -> float:
        return float(
            debye.surface_energy(
                self.t_hot,
                self.t_debye_graphene,
                debye.NUM_ATOMS_UNITCELL_GRAPHENE,
                self.physics.boltzmann,
            )
        )

    def gap_energy_table(self, resolution: int = 512) -> debye.GapEnergyTable:
        return debye.GapEnergyTable.build(
            gap_bottom=self.geometry.gap_bottom,
            gap_top=self.geometry.gap_top,
            t_hot=self.t_hot,
            t_cold=self.t_cold,
            boltzmann=self.physics.boltzmann,
            t_debye=self.t_debye_alumina,
            resolution=resolution,
        )

    def scaled_to(self, target_particles: int) -> "PoreConfig":
        """Scale the geometry so the ideal-gas molecule count ~= target."""
        base = self.physics.num_molecules(self.geometry.volume)
        s = (target_particles / base) ** (1.0 / 3.0)
        return dataclasses.replace(self, geometry=self.geometry.scaled(s))


def temperature_pore_config(**kwargs) -> PoreConfig:
    """The north-star workload (Temperature_Pore_MC.py)."""
    kwargs.setdefault("energized", True)
    return PoreConfig(**kwargs)


def _required_cell_size(cfg: EngineConfig, physics: GasPhysics,
                        density: float) -> float:
    """Cell edge length: >= search radius, targeting ``cell_occupancy``."""
    search_radius = physics.collision_range + cfg.skin
    occupancy_size = (cfg.cell_occupancy / density) ** (1.0 / 3.0)
    return max(search_radius, occupancy_size)


def cell_size_for(cfg_engine: EngineConfig, physics: GasPhysics,
                  num_particles: int, fluid_volume: float) -> float:
    density = num_particles / fluid_volume
    return _required_cell_size(cfg_engine, physics, density)


def cell_capacity_for(cfg_engine: EngineConfig, physics: GasPhysics,
                      num_particles: int, fluid_volume: float) -> int:
    """Per-cell slot count covering the Poisson occupancy tail."""
    if cfg_engine.cell_capacity is not None:
        return cfg_engine.cell_capacity
    density = num_particles / fluid_volume
    size = _required_cell_size(cfg_engine, physics, density)
    occ = density * size**3
    cap = occ + 5.0 * math.sqrt(max(occ, 1.0)) + 4.0
    return int(math.ceil(cap / 8.0) * 8)
