#!/usr/bin/env python3
"""Kinetic-energy drift of the sharded cube in both packages, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/torch_sharded_cube_energy.py [steps]

Runs the specular cube (``CubeConfig`` on the cell grid, 24,627 particles,
float64) for ``steps`` steps (default 20) with the JAX package's
``ShardedSimulation`` on 2 and 4 virtual CPU devices and with the port's
``ShardedSimulation`` on 2 and 4 slabs, and prints for each the relative
change of the summed squared speeds and the collisions.  The walls are
specular and the collisions elastic, so an exact engine keeps the energy
to rounding; a pair resolved on one slab and not on the other does not.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import argon_monte_carlo_tpu as amc  # noqa: E402
import argon_monte_carlo_tpu_torch as amt  # noqa: E402
from argon_monte_carlo_tpu.config import EngineConfig as JEngine  # noqa: E402
from argon_monte_carlo_tpu.parallel import shard as jshard  # noqa: E402
from argon_monte_carlo_tpu.parallel.mesh import make_mesh  # noqa: E402


def main(steps: int) -> None:
    engine = dict(dtype="float64", broadphase="cells", steps_per_epoch=steps)
    for slabs in (2, 4):
        cfg = amc.CubeConfig(engine=JEngine(**engine))
        sim = jshard.ShardedSimulation(amc.make_workload(cfg),
                                       mesh=make_mesh(slabs))
        (st, valid, gid), measure, key = sim.init()
        v = np.asarray(valid)
        e0 = float((np.asarray(st.vel)[v] ** 2).sum())
        (st, valid, gid), measure, met = sim.run(
            num_steps=steps, state=(st, valid, gid), measure=measure,
            run_key=key)
        v = np.asarray(valid)
        e1 = float((np.asarray(st.vel)[v] ** 2).sum())
        print(f"JAX  sharded cube, {slabs} slabs, {steps} steps: kinetic "
              f"energy {e1 / e0 - 1:+.3e} relative, collisions "
              f"{int(np.asarray(met.collisions).sum())}")
    for slabs in (2, 4):
        cfg = amt.CubeConfig(engine=amt.EngineConfig(**engine))
        sim = amt.ShardedSimulation(amt.make_workload(cfg), n_shards=slabs,
                                    devices=["cpu"])
        state, measure, gens = sim.init()

        def energy(state):
            return sum(float((st.vel[v] ** 2).sum()) for st, v, _ in state)

        e0 = energy(state)
        state, measure, met = sim.run(steps, state=state, measure=measure,
                                      generators=gens)
        print(f"port sharded cube, {slabs} slabs, {steps} steps: kinetic "
              f"energy {energy(state) / e0 - 1:+.3e} relative, collisions "
              f"{int(met.collisions.sum())}")
    print(f"torch {torch.__version__}, jax {jax.__version__}, CPU")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 20)
