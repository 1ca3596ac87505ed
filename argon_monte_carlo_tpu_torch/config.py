"""Workload and engine configuration for the PyTorch port.

Mirrors ``argon_monte_carlo_tpu.config`` for the cube and the temperature
pore.  ``EngineConfig`` keeps only the knobs that change physics or shapes;
the reference's compile-wall and TPU lane-geometry knobs have no
counterpart here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .geometry import CubeGeometry, PoreGeometry
from .physics import (CUBE_PHYSICS, GasPhysics, PORE_PHYSICS,
                      TEMPERATURE_PORE_PHYSICS)
from .utils import debye

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Execution knobs of the sweep and pairs engines."""

    # "float32" (the card's working type) or "float64" (CPU parity tests).
    dtype: str = "float32"
    # Pair broad phase: "cells" (the cell grid, scales to millions) or
    # "allpairs" (the exact O(N^2) search, K11; the cube's default).
    broadphase: str = "cells"
    # Target mean particles per occupied cell (sets the cell size).
    cell_occupancy: float = 11.0
    # Slots per cell; None = auto from the occupancy Poisson tail.
    cell_capacity: Optional[int] = None
    # Most rows a block of the all-pairs search's plain version (the
    # kernel stages its own tiles).
    allpairs_tile: int = 2048
    # Steps per epoch: the host looks at results only between epochs.
    steps_per_epoch: int = 100
    # Free-path histograms (reference: 200 bins over (0, 1e-6)).
    num_bins: int = 200
    hist_range: tuple[float, float] = (0.0, 1e-6)
    # Narrow phase: "sweep" (the full 27-neighbourhood sweep every step) or
    # "pairs" (the Verlet reach-pair list, rebuilt every rebuild_interval
    # steps; ops/pairs.py).
    narrowphase: str = "sweep"
    # Steps between pair-list rebuilds (K); the sweep requires 1.
    rebuild_interval: int = 1
    # Flush staged histogram events every N steps (1 = exact).
    hist_flush_interval: int = 1
    # Extra search radius beyond collision_range (metres).
    skin: float = 0.0
    # Count non-finite state elements per step.
    check_finite: bool = False
    # The reference's missed-case audit: re-evaluate every wall-case
    # predicate after the wall pass and report the residual counts per
    # step (StepMetrics.missed_cases; Open_Air_Pore_MC.py:488-511).
    debug_audits: bool = False

    def __post_init__(self):
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")
        if self.narrowphase not in ("sweep", "pairs"):
            raise ValueError(f"unknown narrowphase {self.narrowphase!r}")
        if self.broadphase not in ("cells", "allpairs"):
            raise ValueError(f"unknown broadphase {self.broadphase!r}")
        if self.narrowphase == "pairs" and self.broadphase != "cells":
            raise ValueError("narrowphase='pairs' requires broadphase='cells'")
        if self.rebuild_interval < 1:
            raise ValueError("rebuild_interval must be >= 1")
        if self.narrowphase == "sweep" and self.rebuild_interval != 1:
            raise ValueError(
                "rebuild_interval > 1 requires narrowphase='pairs' (the "
                "sweep rebuilds its cell structure every step)"
            )

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


@dataclasses.dataclass(frozen=True)
class CubeConfig:
    """Stage 1: the specular cube (reference Open_Air_Cube_MC.py:26-82).
    At its published size it holds 24,627 particles for 500 steps."""

    geometry: CubeGeometry = CubeGeometry()
    physics: GasPhysics = CUBE_PHYSICS
    seed: int = 127
    nmft: int = 20  # mean-free times to run (Open_Air_Cube_MC.py:62)
    steps_per_mft: int = 25  # (Open_Air_Cube_MC.py:63)
    engine: EngineConfig = EngineConfig(broadphase="allpairs")
    num_particles_override: Optional[int] = None
    # The reference's stratified position fill (Open_Air_Cube_MC.py:144-156)
    # instead of the plain uniform one (the same single-particle
    # distribution).
    stratified_init: bool = False
    init_cells_per_axis: int = 15  # Open_Air_Cube_MC.py:30

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
        # dt = Nmft * tau / num_timesteps (Open_Air_Cube_MC.py:64)
        return self.nmft * self.physics.tau / self.num_timesteps


@dataclasses.dataclass(frozen=True)
class PoreConfig:
    """Thruster pore: specular (Open_Air_Pore_MC, the default) or, with
    ``energized=True``, the thermal-wall pore (Temperature_Pore_MC)."""

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


def pairs_cell_capacity_for(cfg_engine: EngineConfig, physics: GasPhysics,
                            num_particles: int, fluid_volume: float) -> int:
    """Slot count of the pairs-rebuild grid (~3.75 sigma of the occupancy
    Poisson tail, rounded to the nearest multiple of 8): a particle that
    loses its slot goes hot and re-searches every step, so coverage holds
    with a thinner tail than the sweep's (config.py:345-372)."""
    if cfg_engine.cell_capacity is not None:
        return cfg_engine.cell_capacity
    density = num_particles / fluid_volume
    size = _required_cell_size(cfg_engine, physics, density)
    occ = density * size**3
    cap = occ + 3.75 * math.sqrt(max(occ, 1.0)) + 1.0
    return max(8, int(round(cap / 8.0) * 8))
