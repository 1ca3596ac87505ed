"""The z-slab domain-decomposed engine of the port."""

from .mesh import make_devices
from .shard import ShardedSimulation, ShardPlan, make_shard_plan

__all__ = ["ShardedSimulation", "ShardPlan", "make_devices",
           "make_shard_plan"]
