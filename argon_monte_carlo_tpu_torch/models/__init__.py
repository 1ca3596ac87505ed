"""Workload builders of the port (the temperature pore; the cube and the
specular pore are ROADMAP queue 1, slice 7)."""

from .temperature_pore import make_temperature_pore_workload

__all__ = ["make_temperature_pore_workload"]
