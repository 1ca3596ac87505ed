"""Carry state and grid tables across from the JAX package, through numpy.

The port never imports JAX.  A caller passes ``np.asarray`` of each field
of the reference's ``ParticleState`` / ``Measurements`` or grid, and gets
the port's dataclasses on ``device``.  The tests use this to start both
engines from one state and to show that the port builds the same grid.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops.collide import DeviceGrid
from .state import Measurements, ParticleState

_INT_FIELDS = {"path_count", "collision_count", "err_count",
               "overflow_count", "hist_drop_count"}


def _tensor(a, dtype, device) -> torch.Tensor:
    # np.array copies: arrays read back from JAX are not writable.
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def state_from_numpy(arrays: dict, device="cpu", dtype=torch.float32):
    """(ParticleState, Measurements or None) from the reference's field
    arrays.  ``arrays`` holds pos, vel, paths, has_collided and, for the
    measurements, their fields too (hist stays float32, counters int32,
    other floats ``dtype``); fields the port does not keep are ignored."""
    state = ParticleState(
        pos=_tensor(arrays["pos"], dtype, device),
        vel=_tensor(arrays["vel"], dtype, device),
        paths=_tensor(arrays["paths"], dtype, device),
        has_collided=_tensor(arrays["has_collided"], torch.bool, device),
    )
    if "hist" not in arrays:
        return state, None

    def field_dtype(name):
        if name in _INT_FIELDS:
            return torch.int32
        if name == "pending_mask":
            return torch.bool
        return torch.float32 if name == "hist" else dtype

    measure = Measurements(**{
        f.name: _tensor(arrays[f.name], field_dtype(f.name), device)
        for f in dataclasses.fields(Measurements)
    })
    return state, measure


def grid_from_numpy(arrays: dict, device="cpu",
                    dtype=torch.float32) -> DeviceGrid:
    """DeviceGrid from the reference grid's arrays (nx, layer_base,
    half_extent, neighbors) and scalars (cell_size, z_lo, nz, num_cells,
    capacity)."""
    return DeviceGrid(
        nx=_tensor(arrays["nx"], torch.int32, device),
        layer_base=_tensor(arrays["layer_base"], torch.int32, device),
        half_extent=_tensor(arrays["half_extent"], dtype, device),
        neighbors=_tensor(arrays["neighbors"], torch.int32, device),
        cell_size=float(arrays["cell_size"]),
        z_lo=float(arrays["z_lo"]),
        nz=int(arrays["nz"]),
        num_cells=int(arrays["num_cells"]),
        capacity=int(arrays["capacity"]),
    )
