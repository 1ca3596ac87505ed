"""Simulation domains (host side, plain Python floats).

Port of ``argon_monte_carlo_tpu.geometry``: the 100 nm specular box
(``CubeGeometry``, Open_Air_Cube_MC.py:26-39) and the thruster pore, a
stack of coaxial cylinders along z (``PoreGeometry``,
Open_Air_Pore_MC.py:23-46, Temperature_Pore_MC.py:28-53).  Every derived
length, volume and segment count equals the reference's exactly.
"""

from __future__ import annotations

import dataclasses
import math

from .physics import GasPhysics


def cylinder_volume(radius: float, height: float) -> float:
    # reference: utils.py:3-4
    return math.pi * radius * radius * height


@dataclasses.dataclass(frozen=True)
class CubeGeometry:
    """Axis-aligned box [0,lx] x [0,ly] x [0,lz] with specular walls."""

    lx: float = 100e-9
    ly: float = 100e-9
    lz: float = 100e-9

    @property
    def volume(self) -> float:
        return self.lx * self.ly * self.lz

    @property
    def bounds(self) -> tuple[tuple[float, float], ...]:
        return ((0.0, self.lx), (0.0, self.ly), (0.0, self.lz))


@dataclasses.dataclass(frozen=True)
class PoreGeometry:
    """Thruster-pore: stack of coaxial cylinders along z.

    z-profile (bottom -> top):

        [0, open_air_height)                       open air, r = open_air_radius
        [open_air_height, gap_bottom)              hot coating, r = pore_coated_radius
        [gap_bottom, gap_top)                      gap, r = gap_radius
        [gap_top, total_height - open_air_height)  cold coating, r = pore_coated_radius
        [total_height - open_air_height, total]    open air, r = open_air_radius
    """

    pore_coated_radius: float = 30e-9
    gap_extra_radius: float = 4e-9  # gap_radius = pore_coated_radius + 4nm
    pore_height: float = 3000e-9
    hot_coating_height: float = 30e-9
    open_air_radius_factor: float = 5.0  # open_air_radius = 5 * pore radius
    open_air_height: float = 100e-9

    @property
    def gap_radius(self) -> float:
        return self.pore_coated_radius + self.gap_extra_radius

    @property
    def open_air_radius(self) -> float:
        return self.open_air_radius_factor * self.pore_coated_radius

    @property
    def gap_height(self) -> float:
        return self.hot_coating_height

    @property
    def cold_coating_height(self) -> float:
        return self.pore_height - self.hot_coating_height - self.gap_height

    @property
    def total_height(self) -> float:
        return self.pore_height + 2.0 * self.open_air_height

    @property
    def gap_bottom(self) -> float:
        return self.open_air_height + self.hot_coating_height

    @property
    def gap_top(self) -> float:
        return self.gap_bottom + self.gap_height

    @property
    def cold_top(self) -> float:
        """z where the cold coating meets the top open-air region."""
        return self.total_height - self.open_air_height

    @property
    def hot_volume(self) -> float:
        return cylinder_volume(self.pore_coated_radius, self.hot_coating_height)

    @property
    def gap_volume(self) -> float:
        return cylinder_volume(self.gap_radius, self.gap_height)

    @property
    def cold_volume(self) -> float:
        return cylinder_volume(self.pore_coated_radius, self.cold_coating_height)

    @property
    def open_air_volume(self) -> float:
        return cylinder_volume(self.open_air_radius, self.open_air_height)

    @property
    def volume(self) -> float:
        return (
            self.hot_volume
            + self.gap_volume
            + self.cold_volume
            + 2.0 * self.open_air_volume
        )

    @property
    def bounds(self) -> tuple[tuple[float, float], ...]:
        r = self.open_air_radius
        return ((-r, r), (-r, r), (0.0, self.total_height))

    # Inset radii keeping particle centres in bounds
    # (Open_Air_Pore_MC.py:66-69).
    def open_air_collision_radius(self, physics: GasPhysics) -> float:
        return self.open_air_radius - physics.argon_radius

    def gap_collision_radius(self, physics: GasPhysics) -> float:
        return self.gap_radius - physics.argon_radius

    def pore_collision_radius(self, physics: GasPhysics) -> float:
        return self.pore_coated_radius - physics.argon_radius

    def scaled(self, length_scale: float) -> "PoreGeometry":
        """Uniformly scale every geometric length (volume scales cubically)."""
        s = float(length_scale)
        return dataclasses.replace(
            self,
            pore_coated_radius=self.pore_coated_radius * s,
            gap_extra_radius=self.gap_extra_radius * s,
            pore_height=self.pore_height * s,
            hot_coating_height=self.hot_coating_height * s,
            open_air_height=self.open_air_height * s,
        )

    def segment_particle_counts(self, num_molecules: int) -> dict[str, int]:
        """Partition N molecules across segments by volume fraction.

        floor() per segment, remainder assigned to the top open-air segment
        (Open_Air_Pore_MC.py:79-83, Temperature_Pore_MC.py:99-103).
        """
        v = self.volume
        open_air = int(math.floor(num_molecules * (self.open_air_volume / v)))
        cold = int(math.floor(num_molecules * (self.cold_volume / v)))
        hot = int(math.floor(num_molecules * (self.hot_volume / v)))
        gap = int(math.floor(num_molecules * (self.gap_volume / v)))
        remaining = num_molecules - gap - hot - cold - 2 * open_air
        return {
            "open_air_bottom": open_air,
            "hot": hot,
            "gap": gap,
            "cold": cold,
            "open_air_top": open_air + remaining,
        }
