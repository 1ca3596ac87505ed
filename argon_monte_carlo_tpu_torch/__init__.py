"""argon_monte_carlo_tpu_torch: the PyTorch/CUDA port of argon_monte_carlo_tpu.

The temperature-pore workload on the cell grid, run by
``Simulation(make_workload(cfg), device="cuda")`` with either narrow
phase: the per-step sweep or the Verlet pair list
(``EngineConfig(narrowphase="pairs", rebuild_interval=K)``).  Their
kernels (cell binning and table, partner sweep, impulse exchange,
histogram flush; rebuild sweep, pair emission, compaction, pair test and
resolve, dirty re-search) are CUDA C++ written for Hopper (``kernels/``);
each has a plain PyTorch twin that runs for tensors on the CPU.

The JAX package ``argon_monte_carlo_tpu`` is the reference this port is
tested against; the port itself imports only torch and numpy.
"""

__version__ = "0.1.0"

from . import config, engine, geometry, init, physics, rng, state  # noqa: F401
from .config import EngineConfig, PoreConfig, temperature_pore_config  # noqa: F401
from .engine import Simulation, Workload  # noqa: F401
from .geometry import PoreGeometry  # noqa: F401
from .models import make_temperature_pore_workload  # noqa: F401
from .physics import GasPhysics  # noqa: F401


def make_workload(cfg):
    """Build the Workload for a config (the temperature pore)."""
    if isinstance(cfg, PoreConfig):
        return make_temperature_pore_workload(cfg)
    raise NotImplementedError(
        f"{type(cfg).__name__} is not ported yet (ROADMAP queue 1, slice 7)"
    )
