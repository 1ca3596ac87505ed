"""The plain reference's physics and geometry, computed from the numbers of
a configuration file alone.

Derived quantities follow the reference scripts' formulas
(Open_Air_Cube_MC.py:26-82, Open_Air_Pore_MC.py:23-83,
Temperature_Pore_MC.py:28-152): the argon radius from the cross-section,
Maxwell's scale, the mean free time and dt, the pore's inset radii and
segment volumes, the Debye surface energies and the gap's energy ramp.
Nothing here imports the program under test.
"""

from __future__ import annotations

import importlib
import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Gas:
    mass: float
    molar_mass: float
    molecules_per_mole: float
    ideal_gas_const: float
    boltzmann: float
    temp_ambient: float
    sigma: float
    pressure: float

    @property
    def argon_radius(self) -> float:
        return math.sqrt(self.sigma / (4.0 * math.pi))

    @property
    def collision_range(self) -> float:
        return 2.0 * self.argon_radius

    @property
    def lambda_mfp(self) -> float:
        return self.boltzmann * self.temp_ambient / (
            math.sqrt(2.0) * self.sigma * self.pressure)

    @property
    def v_mean(self) -> float:
        return math.sqrt(3.0 * self.ideal_gas_const * self.temp_ambient
                         / self.molar_mass)

    @property
    def a_shape(self) -> float:
        return math.sqrt(self.boltzmann * self.temp_ambient / self.mass)

    @property
    def tau(self) -> float:
        return self.lambda_mfp / self.v_mean

    def num_molecules(self, volume: float) -> int:
        moles = volume * self.pressure / (self.ideal_gas_const
                                          * self.temp_ambient)
        return int(round(moles * self.molecules_per_mole))


def cylinder_volume(radius: float, height: float) -> float:
    return math.pi * radius * radius * height


@dataclass(frozen=True)
class Pore:
    """The five coaxial cylinders along z (open air, hot coating, gap,
    cold coating, open air)."""

    pore_coated_radius: float
    gap_extra_radius: float
    pore_height: float
    hot_coating_height: float
    open_air_radius_factor: float
    open_air_height: float

    def scaled(self, s: float) -> "Pore":
        return Pore(self.pore_coated_radius * s, self.gap_extra_radius * s,
                    self.pore_height * s, self.hot_coating_height * s,
                    self.open_air_radius_factor, self.open_air_height * s)

    @property
    def gap_radius(self):
        return self.pore_coated_radius + self.gap_extra_radius

    @property
    def open_air_radius(self):
        return self.open_air_radius_factor * self.pore_coated_radius

    @property
    def gap_height(self):
        return self.hot_coating_height

    @property
    def cold_coating_height(self):
        return self.pore_height - self.hot_coating_height - self.gap_height

    @property
    def total_height(self):
        return self.pore_height + 2.0 * self.open_air_height

    @property
    def gap_bottom(self):
        return self.open_air_height + self.hot_coating_height

    @property
    def gap_top(self):
        return self.gap_bottom + self.gap_height

    @property
    def cold_top(self):
        return self.total_height - self.open_air_height

    @property
    def segment_volumes(self):
        return dict(
            hot=cylinder_volume(self.pore_coated_radius,
                                self.hot_coating_height),
            gap=cylinder_volume(self.gap_radius, self.gap_height),
            cold=cylinder_volume(self.pore_coated_radius,
                                 self.cold_coating_height),
            open_air=cylinder_volume(self.open_air_radius,
                                     self.open_air_height))

    @property
    def volume(self):
        v = self.segment_volumes
        return v["hot"] + v["gap"] + v["cold"] + 2.0 * v["open_air"]

    def segment_counts(self, n: int) -> dict:
        """floor() of each segment's volume share, the remainder to the top
        open-air segment (Temperature_Pore_MC.py:99-103)."""
        v, total = self.segment_volumes, self.volume
        oa = int(math.floor(n * (v["open_air"] / total)))
        cold = int(math.floor(n * (v["cold"] / total)))
        hot = int(math.floor(n * (v["hot"] / total)))
        gap = int(math.floor(n * (v["gap"] / total)))
        rest = n - gap - hot - cold - 2 * oa
        return dict(open_air_bottom=oa, hot=hot, gap=gap, cold=cold,
                    open_air_top=oa + rest)


def debye_integral(upper, num_nodes: int = 128):
    """Integral_0^upper x^3 / (e^x - 1) dx by Gauss-Legendre quadrature."""
    upper = np.asarray(upper, dtype=np.float64)
    nodes, weights = np.polynomial.legendre.leggauss(num_nodes)
    half = upper[..., None] / 2.0
    x = half * (nodes + 1.0)
    f = np.where(x > 0.0, x**3 / np.expm1(np.where(x > 0.0, x, 1.0)), 0.0)
    return np.sum(weights * f, axis=-1) * np.squeeze(half, axis=-1)


def surface_energy(temperature, t_debye: float, atoms: int,
                   boltzmann: float):
    """Debye surface energy E_surf(T) (Temperature_Pore_MC.py:83-84)."""
    t = np.asarray(temperature, dtype=np.float64)
    return 9.0 * t * atoms * boltzmann * (t / t_debye) ** 3 * \
        debye_integral(t_debye / t)


def gap_energy_power(gap_bottom, gap_top, t_hot, t_cold, boltzmann,
                     t_debye, atoms, resolution=512):
    """E_surf(z) of the gap's linear temperature ramp, sampled at
    ``resolution`` points and fitted by a degree-12 Chebyshev series, in
    the power basis of t = 2 (z - lo) / (hi - lo) - 1, highest first."""
    z = np.linspace(gap_bottom, gap_top, resolution)
    temps = t_hot + (t_cold - t_hot) * ((z - gap_bottom)
                                        / (gap_top - gap_bottom))
    e = surface_energy(temps, t_debye, atoms, boltzmann)
    x = np.linspace(-1.0, 1.0, len(e))
    coeffs = np.polynomial.chebyshev.chebfit(x, e, deg=min(12, len(e) - 1))
    return tuple(float(c) for c in
                 np.polynomial.chebyshev.cheb2poly(coeffs)[::-1])


@dataclass(frozen=True)
class Setup:
    """Everything a reference step needs, from a configuration file.
    ``kind`` names the module ``reference/<kind>.py`` that sets it up and
    steps its walls; ``geometry`` and ``params`` are that module's own."""

    kind: str
    gas: Gas
    n: int
    dt: float
    num_bins: int
    hist_hi: float
    geometry: object = None
    params: dict | None = None

    @property
    def cr(self) -> float:
        return self.gas.collision_range


def kind(name: str):
    """The module of a workload kind, ``reference/<name>.py``, found by
    the configuration's ``workload``: ``setup``, ``draw_positions``,
    ``walls`` and ``after_collisions``."""
    return importlib.import_module(f"{__package__}.{name}")


def setup_from(cfg: dict) -> Setup:
    """The reference's view of a configuration file (``configs/*.json``):
    the gas, dt and the histogram here, the rest by its kind."""
    gas = Gas(**cfg["gas"])
    hist = cfg["histogram"]
    steps = cfg["nmft"] * cfg["steps_per_mft"]
    dt = cfg["nmft"] * gas.tau / steps
    return kind(cfg["workload"]).setup(cfg, gas, dt, hist["num_bins"],
                                       hist["hi"])
