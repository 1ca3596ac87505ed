"""The port imports neither JAX nor the JAX package: both are blocked in a
fresh interpreter, which then imports every port module and runs two
steps each of the sweep engine, the pairs engine, the cube, the specular
pore and the 4-slab sharded sweep on the CPU."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = """
import sys
sys.modules["jax"] = None
sys.modules["argon_monte_carlo_tpu"] = None
import importlib, pkgutil
import argon_monte_carlo_tpu_torch as amt
for info in pkgutil.walk_packages(amt.__path__, "argon_monte_carlo_tpu_torch."):
    importlib.import_module(info.name)
cfg = amt.temperature_pore_config().scaled_to(2000)
sim = amt.Simulation(amt.make_workload(cfg), device="cpu")
state, measure, metrics = sim.run(num_steps=2)
assert metrics.collisions.shape == (2,)
cfg = amt.temperature_pore_config(engine=amt.EngineConfig(
    narrowphase="pairs", rebuild_interval=8)).scaled_to(2000)
sim = amt.Simulation(amt.make_workload(cfg), device="cpu")
_, _, metrics = sim.run(num_steps=2)
assert metrics.rebuilt.tolist() == [1, 0]
cfg = amt.CubeConfig(num_particles_override=500)
sim = amt.Simulation(amt.make_workload(cfg), device="cpu")
cube, _, metrics = sim.run(num_steps=2)
assert metrics.collisions.shape == (2,) and cube.num_particles == 500
cfg = amt.PoreConfig().scaled_to(2000)
sim = amt.Simulation(amt.make_workload(cfg), device="cpu")
_, specular, metrics = sim.run(num_steps=2)
assert metrics.wall_hits.shape == (2,) and int(specular.err_count) == 0
cfg = amt.temperature_pore_config().scaled_to(2000)
sim = amt.ShardedSimulation(amt.make_workload(cfg), n_shards=4,
                            devices=["cpu"])
slabs, per_slab, metrics = sim.run(num_steps=2)
assert metrics.collisions.shape == (2,) and len(slabs) == len(per_slab) == 4
assert sum(int(valid.sum()) for _, valid, _ in slabs) == cfg.num_molecules
assert int(sim.finalize_measure(per_slab).overflow_count) == 0
assert not any(m == "jax" or m.startswith(("jax.", "jaxlib"))
               for m in sys.modules if sys.modules[m] is not None)
print("ok", int(measure.collision_count))
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok ")
