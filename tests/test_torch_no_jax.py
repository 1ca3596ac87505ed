"""The port imports neither JAX nor the JAX package: both are blocked in a
fresh interpreter, which then imports every port module and runs two
steps of the sweep engine and two of the pairs engine on the CPU."""

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
