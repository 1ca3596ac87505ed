#!/usr/bin/env python3
"""SHA-256 of the port's results on the card, to hold two checkouts to
the bit: the pore at 1M particles through the pairs step (K = 8, replayed
from CUDA graphs) for 300 steps, the sweep and the cube for 200 each, and
the sharded pairs mode (4 z-slabs, all on the one card) of the temperature
pore and of the specular pore at 1M particles for 100 steps each, and the
specular pore at 1M through the replayed pairs step for 100 steps.

Run it beside the package to hash (the package is imported from
``PYTHONPATH``, so one copy of the script reads any checkout):

    PYTHONPATH=. python3 scripts/torch_result_hashes.py
    PYTHONPATH=_tree_check/parent python3 scripts/torch_result_hashes.py

Prints one line a run: the digest of every tensor of the final state,
measurements, per-step ``StepMetrics`` and (pairs) the carried pair list
and its window (sharded: every slab's state, lanes, ids, measurements and
pair window, in slab order), and the package it read.
"""

from __future__ import annotations

import dataclasses
import hashlib
import sys

import torch

import argon_monte_carlo_tpu_torch as amt

SEED = 17


def digest(*objs) -> str:
    h = hashlib.sha256()
    for obj in objs:
        for f in dataclasses.fields(obj):
            t = getattr(obj, f.name)
            h.update(f.name.encode())
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def run(label: str, cfg, steps: int) -> None:
    sim = amt.Simulation(amt.make_workload(cfg), device="cuda")
    state, measure, metrics = sim.run(num_steps=steps, seed=SEED)
    torch.cuda.synchronize()
    window = sim.pair_window()
    extra = () if window is None else (window[0],)
    tail = "" if window is None else f" window_left={window[1]}"
    sha = digest(state, measure, metrics, *extra)
    print(f"{label}: N={state.num_particles} steps={steps} replayed="
          f"{sim.replayed_steps} sha256={sha}{tail}")


def run_sharded(label: str, cfg, steps: int) -> None:
    sim = amt.ShardedSimulation(amt.make_workload(cfg), n_shards=4,
                                devices=["cuda"])
    slabs, measure, metrics = sim.run(num_steps=steps, seed=SEED)
    torch.cuda.synchronize()
    windows, left = sim.pair_window()
    h = hashlib.sha256(digest(metrics).encode())
    for (state, valid, gid), meas, win in zip(slabs, measure, windows):
        h.update(digest(state, meas, win.plist).encode())
        lists = [getattr(win, f.name) for f in dataclasses.fields(win)
                 if f.name != "plist"]
        for t in [valid, gid] + lists:
            h.update(t.contiguous().cpu().numpy().tobytes())
    live = sum(int(valid.sum()) for _, valid, _ in slabs)
    print(f"{label}: N={live} slabs=4 steps={steps} sha256={h.hexdigest()} "
          f"window_left={left}")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_result_hashes: needs a CUDA card", file=sys.stderr)
        return 1
    print(f"package {amt.__file__}")
    eng = dict(broadphase="cells", steps_per_epoch=100)
    run("pairs", amt.temperature_pore_config(engine=amt.EngineConfig(
        narrowphase="pairs", rebuild_interval=8, **eng)).scaled_to(
            1_000_000), 300)
    run("sweep", amt.temperature_pore_config(engine=amt.EngineConfig(
        **eng)).scaled_to(1_000_000), 200)
    run("cube", amt.CubeConfig(), 200)
    pairs = amt.EngineConfig(narrowphase="pairs", rebuild_interval=8, **eng)
    run_sharded("sharded pairs", amt.temperature_pore_config(
        engine=pairs).scaled_to(1_000_000), 100)
    run_sharded("sharded pairs, specular pore", amt.PoreConfig(
        engine=pairs).scaled_to(1_000_000), 100)
    run("pairs, specular pore", amt.PoreConfig(engine=pairs).scaled_to(
        1_000_000), 100)
    return 0


if __name__ == "__main__":
    sys.exit(main())
