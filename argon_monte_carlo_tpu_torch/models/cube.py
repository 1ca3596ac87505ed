"""Stage 1 workload: the specular cube (reference Open_Air_Cube_MC.py).

Port of ``argon_monte_carlo_tpu.models.cube``: six specular plane walls;
walls do not end free paths (only pair collisions do,
Open_Air_Cube_MC.py:189-226 vs 267-280), there is no recapture pass, and
the ledger is empty.  The wall pass stays plain PyTorch; the cube's
kernel is its broad phase, the all-pairs search (K11).
"""

from __future__ import annotations

import torch

from ..config import CubeConfig
from ..engine import WallLedger, Workload, advance_plain
from ..init import init_cube
from ..ops import walls as wall_ops


def make_cube_workload(cfg: CubeConfig) -> Workload:
    geom = cfg.geometry

    def wall_pass(state, prior, measure, uniforms, cases=None):
        del prior, uniforms
        for axis, hi in ((0, geom.lx), (1, geom.ly), (2, geom.lz)):
            for name, mask, plane in (
                    ("high", state.pos[:, axis] > hi, hi),
                    ("low", state.pos[:, axis] < 0.0, 0.0)):
                if cases is not None:
                    cases[f"axis {axis} {name}"] = mask
                state = wall_ops.specular_plane(state, mask, axis,
                                                plane).state
        dev = state.pos.device
        zero = torch.zeros((), dtype=state.pos.dtype, device=dev)
        count = torch.zeros((), dtype=torch.int32, device=dev)
        ledger = WallLedger(momentum_z=zero, energy_hot=zero,
                            energy_cold=zero, wall_hits=count, errs=count)
        return state, measure, ledger

    def no_recapture(state):
        return state, torch.zeros((), dtype=torch.int32,
                                  device=state.pos.device)

    advance = advance_plain(wall_pass, no_recapture, cfg.dt)
    return Workload(
        cfg=cfg,
        init_fn=lambda gen, device: init_cube(cfg, gen, device),
        wall_pass=wall_pass,
        advance=advance,
        advance_plain=advance,
        post_pairs=no_recapture,
        fluid_volume=geom.volume,
    )
