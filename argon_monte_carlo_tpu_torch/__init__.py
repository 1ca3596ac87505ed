"""argon_monte_carlo_tpu_torch: the PyTorch/CUDA port of argon_monte_carlo_tpu.

Three workloads run by ``Simulation(make_workload(cfg), device="cuda")``:
the temperature pore and the specular pore (``PoreConfig``) on the cell
grid with either narrow phase (the per-step sweep or the Verlet pair list,
``EngineConfig(narrowphase="pairs", rebuild_interval=K)``), and the
specular cube (``CubeConfig``) with the all-pairs broad phase.
``ShardedSimulation(make_workload(cfg), n_shards=S)`` runs the same
workloads on the cell grid (either narrow phase for the pores, the sweep
for the cube) cut into S z-slabs with halo exchange and migration, the
slabs dealt over the visible cards (all on one card where there is one).
Their kernels
(the fused drift/walls/recapture pass; cell binning and table, partner
sweep, impulse exchange, histogram flush; rebuild sweep, pair emission,
compaction, pair test and resolve, dirty re-search; the all-pairs search;
halo and migrant packing) are CUDA C++ written for Hopper (``kernels/``);
each has a plain PyTorch twin that runs for tensors on the CPU.

The JAX package ``argon_monte_carlo_tpu`` is the reference this port is
tested against; the port itself imports only torch and numpy.
"""

__version__ = "0.1.0"

from . import config, engine, geometry, init, physics, rng, state  # noqa: F401
from .config import (CubeConfig, EngineConfig, PoreConfig,  # noqa: F401
                     temperature_pore_config)
from .engine import Simulation, Workload  # noqa: F401
from .geometry import CubeGeometry, PoreGeometry  # noqa: F401
from .models import (make_cube_workload, make_pore_workload,  # noqa: F401
                     make_temperature_pore_workload)
from .parallel import ShardedSimulation, make_devices  # noqa: F401
from .physics import GasPhysics  # noqa: F401


def make_workload(cfg):
    """Build the Workload for a config (the cube, the specular pore or the
    temperature pore)."""
    if isinstance(cfg, CubeConfig):
        return make_cube_workload(cfg)
    if isinstance(cfg, PoreConfig):
        if cfg.energized:
            return make_temperature_pore_workload(cfg)
        return make_pore_workload(cfg)
    raise TypeError(f"no workload for a {type(cfg).__name__}")
