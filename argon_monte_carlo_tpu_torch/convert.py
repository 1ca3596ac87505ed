"""Carry state and grid tables across from the JAX package, through numpy.

The port never imports JAX.  A caller passes ``np.asarray`` of each field
of the reference's ``ParticleState`` / ``Measurements`` or grid, and gets
the port's dataclasses on ``device``.  The tests use this to start both
engines from one state and to show that the port builds the same grid.
The sharded engines differ in layout: the reference keeps one flat array
of ``n_shards * capacity`` lanes (and measurements stacked along a leading
slab axis), the port one entry a slab; ``sharded_state_from_numpy`` and
``sharded_state_to_numpy`` go between the two.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops.collide import DeviceGrid, active_rank_for, cell_runs
from .ops.pairs import PairList
from .state import Measurements, ParticleState

_INT_FIELDS = {"path_count", "collision_count", "err_count",
               "overflow_count", "hist_drop_count", "hot_spill_count",
               "halo_trunc_count"}


def _tensor(a, dtype, device) -> torch.Tensor:
    # np.array copies: arrays read back from JAX are not writable.
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def state_from_numpy(arrays: dict, device="cpu", dtype=torch.float32):
    """(ParticleState, Measurements or None) from the reference's field
    arrays.  ``arrays`` holds pos, vel, paths, has_collided and, for the
    measurements, their fields too (hist stays float32, counters int32,
    other floats ``dtype``); fields the port does not keep are ignored and
    a counter that ``arrays`` lacks starts at zero."""
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
        f.name: _tensor(arrays.get(f.name, 0) if f.name in _INT_FIELDS
                        else arrays[f.name], field_dtype(f.name), device)
        for f in dataclasses.fields(Measurements)
    })
    return state, measure


def grid_from_numpy(arrays: dict, device="cpu",
                    dtype=torch.float32) -> DeviceGrid:
    """DeviceGrid from the reference grid's arrays (nx, layer_base,
    half_extent, neighbors, and active_cells if it has a list) and scalars
    (cell_size, z_lo, nz, num_cells, capacity)."""
    num_cells = int(arrays["num_cells"])
    return DeviceGrid(
        nx=_tensor(arrays["nx"], torch.int32, device),
        layer_base=_tensor(arrays["layer_base"], torch.int32, device),
        half_extent=_tensor(arrays["half_extent"], dtype, device),
        neighbors=_tensor(arrays["neighbors"], torch.int32, device),
        cell_size=float(arrays["cell_size"]),
        z_lo=float(arrays["z_lo"]),
        nz=int(arrays["nz"]),
        num_cells=num_cells,
        capacity=int(arrays["capacity"]),
        active_rank=_tensor(
            active_rank_for(num_cells, arrays.get("active_cells")),
            torch.int32, device),
        run_start=_tensor(cell_runs(arrays["nx"], arrays["layer_base"]),
                          torch.int32, device),
    )


def pairlist_from_numpy(arrays: dict, capacity: int, device="cpu",
                        dtype=torch.float32) -> PairList:
    """The port's PairList from the fields of the reference's (a, b,
    cursor, age, mega0, pslot0, hot, pending1, overflow, spill).  mega0's
    planes x, y, z, index-as-float and reach, ``capacity`` slots each,
    become pos0 (rows, cap, 3), the int32 idx0 and reach0."""
    mega0 = np.asarray(arrays["mega0"])
    rows = mega0.shape[0]
    planes = mega0.reshape(rows, 5, capacity)
    return PairList(
        a=_tensor(arrays["a"], torch.int32, device),
        b=_tensor(arrays["b"], torch.int32, device),
        cursor=_tensor(arrays["cursor"], torch.int32, device),
        age=_tensor(arrays["age"], torch.int32, device),
        pos0=_tensor(np.moveaxis(planes[:, :3], 1, 2), dtype, device),
        idx0=_tensor(planes[:, 3], torch.int32, device),
        reach0=_tensor(planes[:, 4], dtype, device),
        pslot0=_tensor(arrays["pslot0"], torch.int32, device),
        hot=_tensor(arrays["hot"], torch.bool, device),
        pending1=_tensor(arrays["pending1"], torch.bool, device),
        overflow=_tensor(arrays["overflow"], torch.int32, device),
        spill=_tensor(arrays["spill"], torch.int32, device),
    )


def sharded_state_from_numpy(arrays: dict, devices, dtype=torch.float32):
    """The port's per-slab lists from the reference's flat sharded state:
    ``arrays`` holds pos, vel, paths, has_collided, valid and gid of
    ``len(devices) * capacity`` lanes and, for the measurements, their
    fields stacked along a leading slab axis.  Returns (state, measure):
    a list of (ParticleState, valid, gid) and a list of Measurements (or
    None), slab s on ``devices[s]``."""
    n_shards = len(devices)
    lanes = np.asarray(arrays["valid"]).shape[0]
    if lanes % n_shards:
        raise ValueError(f"{lanes} lanes do not split into {n_shards} slabs")
    cap = lanes // n_shards
    fields = [f.name for f in dataclasses.fields(Measurements)]
    state, measure = [], []
    for s, dev in enumerate(devices):
        rows = slice(s * cap, (s + 1) * cap)
        part = {k: np.asarray(arrays[k])[rows]
                for k in ("pos", "vel", "paths", "has_collided")}
        if "hist" in arrays:
            part.update({k: np.asarray(arrays[k])[s] for k in fields
                         if k in arrays})
        st, meas = state_from_numpy(part, dev, dtype)
        state.append((st,
                      _tensor(np.asarray(arrays["valid"])[rows], torch.bool,
                              dev),
                      _tensor(np.asarray(arrays["gid"])[rows], torch.int32,
                              dev)))
        measure.append(meas)
    return state, (measure if "hist" in arrays else None)


def sharded_state_to_numpy(state, measure=None) -> dict:
    """The reference's layout from the port's per-slab lists: the state's
    arrays, valid and gid concatenated over the slabs, and each
    measurement field stacked along a leading slab axis."""
    out = {
        name: np.concatenate([getattr(st, name).cpu().numpy()
                              for st, _, _ in state])
        for name in ("pos", "vel", "paths", "has_collided")}
    out["valid"] = np.concatenate([v.cpu().numpy() for _, v, _ in state])
    out["gid"] = np.concatenate([g.cpu().numpy() for _, _, g in state])
    if measure is not None:
        for f in dataclasses.fields(Measurements):
            out[f.name] = np.stack([getattr(m, f.name).cpu().numpy()
                                    for m in measure])
    return out
