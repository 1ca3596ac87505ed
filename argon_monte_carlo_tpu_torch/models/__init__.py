"""The port's workloads: the cube, the specular pore and the temperature
pore, each made from its config."""

from .cube import make_cube_workload
from .pore import make_pore_workload
from .temperature_pore import make_temperature_pore_workload

__all__ = ["make_cube_workload", "make_pore_workload",
           "make_temperature_pore_workload"]
