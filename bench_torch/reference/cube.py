"""The closed box (Open_Air_Cube_MC.py): its set-up from a configuration
file, its uniform fill, and its six specular planes in a step.  It keeps
no ledger."""

from __future__ import annotations

import torch

from . import walls as W
from .model import Setup


def setup(cfg: dict, gas, dt: float, num_bins: int, hist_hi: float):
    b = cfg["box"]
    box = (b["lx"], b["ly"], b["lz"])
    n = cfg.get("num_particles") or gas.num_molecules(
        box[0] * box[1] * box[2])
    return Setup(cfg["workload"], gas, n, dt, num_bins, hist_hi,
                 geometry=box)


def draw_positions(setup: Setup, rand, device) -> torch.Tensor:
    extent = torch.tensor(setup.geometry, dtype=torch.float32,
                          device=device)
    return rand((setup.n, 3)) * extent


def walls(S, prior, uniforms, setup: Setup):
    W.cube_walls(S, setup)
    zero = torch.zeros((), dtype=S["pos"].dtype, device=prior.device)
    hits = torch.zeros((), dtype=torch.int32, device=prior.device)
    return zero, zero, zero, hits


def after_collisions(S, setup: Setup) -> None:
    pass
