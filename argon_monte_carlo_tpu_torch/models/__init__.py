"""Workload builders of the port: the cube and the temperature pore (the
specular pore is ROADMAP queue 1, slice 7)."""

from .cube import make_cube_workload
from .temperature_pore import make_temperature_pore_workload

__all__ = ["make_cube_workload", "make_temperature_pore_workload"]
