"""Band and index packing (K12): the masked lanes of a slab, in ascending
lane order, in a buffer of fixed size.

Port of ``_compact_band`` and ``_compact_idx`` of
``argon_monte_carlo_tpu.parallel.shard`` (shard.py:210-250).  The z-slab
engine packs its halo bands and its migrants before each exchange with
``pack_band_pair``, both directions of the exchange in one call, which
selects the lanes itself from ``valid`` and the positions' z;
``pack_band`` packs the lanes of a mask; ``pack_indices`` is the
index-only form that the sharded pairs mode will freeze its export lists
with.  Each launches its CUDA kernel (``kernels/csrc/pack.cu``, one launch
a call) for CUDA tensors and runs its plain version for CPU ones.  The
kernel's scratch is the single-pass scan's of K6 and K3
(``ops/compact.lookback_scratch``): kept for each device and stream and
left zero by the kernel, so a call allocates nothing but its outputs and
a launch recorded in a CUDA graph replays correctly (after one call on the
capturing stream, as for K6).

Each ranks the selected lanes by a prefix sum, keeps the lanes with
``rank < capacity`` (those dropped are the highest lanes), and returns a
``flag`` over the slots that were filled and ``dropped``, the number of
selected lanes that did not fit.  An unfilled slot holds ``SENTINEL`` in
the field named ``pos`` (a far-away position that no search can reach), 0
in every other field, and ``n`` in the index form.
"""

from __future__ import annotations

import math
import struct

import torch

from .. import kernels
from . import compact

# The position of a lane that holds no particle (shard.py:49).
SENTINEL = 1e9
# Fields the kernel packs in one launch (pos, vel, paths, has_collided, gid).
MAX_FIELDS = 5


def _fill_of(name: str) -> float:
    return SENTINEL if name == "pos" else 0


def _fill_bits(name: str, dtype: torch.dtype) -> int:
    """The fill as the element's bit pattern (a float32 goes as int32)."""
    if dtype == torch.float32:
        return struct.unpack("<i", struct.pack("<f", _fill_of(name)))[0]
    return int(_fill_of(name))


def _ranked(mask: torch.Tensor, capacity: int):
    """(kept lanes ascending, flag, dropped) of the plain versions."""
    lanes = torch.nonzero(mask).flatten()
    kept = lanes[:capacity]
    flag = torch.zeros(capacity, dtype=torch.bool, device=mask.device)
    flag[: kept.shape[0]] = True
    dropped = torch.clamp(torch.sum(mask, dtype=torch.int32) - capacity,
                          min=0)
    return kept, flag, dropped


def pack_band_plain(fields: dict, mask: torch.Tensor, capacity: int):
    """Plain version of K12.  ``fields`` maps a name to an (n, ...) tensor;
    returns (buf, flag, dropped): ``buf[name]`` (capacity, ...) holds the
    kept lanes' rows from slot 0 up and the fill after them, ``flag``
    (capacity,) bool the filled slots, ``dropped`` () int32."""
    kept, flag, dropped = _ranked(mask, capacity)
    buf = {}
    for name, arr in fields.items():
        out = torch.full((capacity,) + tuple(arr.shape[1:]), _fill_of(name),
                         dtype=arr.dtype, device=arr.device)
        out[: kept.shape[0]] = arr[kept]
        buf[name] = out
    return buf, flag, dropped


def pack_indices_plain(mask: torch.Tensor, capacity: int):
    """Plain version of K12's index form: (idx (capacity,) int32 -- the
    kept lanes, then n --, flag, dropped)."""
    kept, flag, dropped = _ranked(mask, capacity)
    idx = torch.full((capacity,), mask.shape[0], dtype=torch.int32,
                     device=mask.device)
    idx[: kept.shape[0]] = kept.to(torch.int32)
    return idx, flag, dropped


def pack_band_pair_plain(fields: dict, valid: torch.Tensor, capacity: int,
                         up_edge, down_edge, up_inclusive: bool = False,
                         rest: bool = False):
    """Plain version of K12's two-direction form: ``pack_band_plain`` on
    the two sides of one exchange as the z-slab step selects them, ``valid
    & (z > up_edge)`` (``>=`` with ``up_inclusive``, the migrants) and
    ``valid & (z < down_edge)`` with z = ``fields["pos"][:, 2]``, a side
    whose edge is None (no neighbour there) selecting nothing.  Returns
    ((buf, flag, dropped) up, (buf, flag, dropped) down), and with
    ``rest`` a third element, the lanes that stay: ``valid & ~(up |
    down)``."""
    z = fields["pos"][:, 2]
    nobody = torch.zeros_like(valid)
    if up_edge is None:
        up = nobody
    else:
        up = valid & ((z >= up_edge) if up_inclusive else (z > up_edge))
    down = nobody if down_edge is None else valid & (z < down_edge)
    out = (pack_band_plain(fields, up, capacity),
           pack_band_plain(fields, down, capacity))
    return out + (valid & ~(up | down),) if rest else out


def _lookback(dev, n: int) -> torch.Tensor:
    return compact.lookback_scratch(dev, -(-n // compact.TILE))


def _field_args(fields: dict, n: int, capacity: int, dev, sides: int):
    """(buffers, the kernel's five arguments a field) of ``fields``; each
    buffer holds ``sides`` x ``capacity`` rows."""
    if len(fields) > MAX_FIELDS:
        raise ValueError(f"{len(fields)} fields; the kernel packs at most "
                         f"{MAX_FIELDS} in a launch")
    p = kernels.ptr
    lead = (capacity,) if sides == 1 else (sides, capacity)
    buf, args = {}, []
    for name, arr in fields.items():
        if arr.dtype not in (torch.float32, torch.int32, torch.bool):
            raise TypeError(f"{name}: dtype {arr.dtype}, the kernel takes "
                            f"float32, int32 and bool")
        kernels.check(arr, name, arr.dtype, (n,) + tuple(arr.shape[1:]), dev)
        out = torch.empty(lead + tuple(arr.shape[1:]), dtype=arr.dtype,
                          device=dev)
        buf[name] = out
        args += [p(arr), p(out),
                 math.prod(arr.shape[1:]) * arr.element_size(),
                 arr.element_size(), _fill_bits(name, arr.dtype)]
    null = kernels.optional_ptr(None)
    args += [null, null, 0, 0, 0] * (MAX_FIELDS - len(fields))
    return buf, args


def pack_band(fields: dict, mask: torch.Tensor, capacity: int):
    """K12 (see ``pack_band_plain``); CUDA kernel for a CUDA mask, one
    launch.  The kernel takes up to ``MAX_FIELDS`` contiguous fields of
    float32, int32 or bool."""
    if kernels.use_plain(mask):
        return pack_band_plain(fields, mask, capacity)
    dev = mask.device
    n = mask.shape[0]
    kernels.check(mask, "mask", torch.bool, (n,), dev)
    buf, args = _field_args(fields, n, capacity, dev, 1)
    flag = torch.empty(capacity, dtype=torch.bool, device=dev)
    dropped = torch.empty((), dtype=torch.int32, device=dev)
    p = kernels.ptr
    kernels.launch("pack_band", dev, p(mask), n, capacity, len(fields),
                   *args, p(flag), p(dropped), p(_lookback(dev, n)))
    return buf, flag, dropped


def pack_band_pair(fields: dict, valid: torch.Tensor, capacity: int,
                   up_edge, down_edge, up_inclusive: bool = False,
                   rest: bool = False):
    """K12's two-direction form (see ``pack_band_pair_plain``); CUDA kernel
    for CUDA tensors: both sides in one launch, selected on the device from
    ``valid`` and ``fields["pos"][:, 2]`` against the 0-d float32 edge
    tensors (never read on the host; None: no neighbour on that side)."""
    if kernels.use_plain(valid):
        return pack_band_pair_plain(fields, valid, capacity, up_edge,
                                    down_edge, up_inclusive, rest)
    dev = valid.device
    n = valid.shape[0]
    kernels.check(valid, "valid", torch.bool, (n,), dev)
    if "pos" not in fields:
        raise ValueError("pack_band_pair selects by fields['pos'][:, 2]")
    pos = fields["pos"]
    kernels.check(pos, "pos", torch.float32, (n, 3), dev)
    for name, edge in (("up_edge", up_edge), ("down_edge", down_edge)):
        if edge is not None:
            kernels.check(edge, name, torch.float32, (), dev)
    buf, args = _field_args(fields, n, capacity, dev, 2)
    flag = torch.empty((2, capacity), dtype=torch.bool, device=dev)
    dropped = torch.empty(2, dtype=torch.int32, device=dev)
    stay = torch.empty(n, dtype=torch.bool, device=dev) if rest else None
    p, opt = kernels.ptr, kernels.optional_ptr
    kernels.launch("pack_band_pair", dev, p(valid), p(pos), n, opt(up_edge),
                   opt(down_edge), int(up_inclusive), capacity, len(fields),
                   *args, p(flag), p(dropped), opt(stay),
                   p(_lookback(dev, n)))
    out = tuple(({name: b[s] for name, b in buf.items()}, flag[s],
                 dropped[s]) for s in range(2))
    return out + (stay,) if rest else out


def pack_indices(mask: torch.Tensor, capacity: int):
    """K12's index form (see ``pack_indices_plain``); CUDA kernel for a
    CUDA mask, one launch."""
    if kernels.use_plain(mask):
        return pack_indices_plain(mask, capacity)
    dev = mask.device
    n = mask.shape[0]
    kernels.check(mask, "mask", torch.bool, (n,), dev)
    idx = torch.empty(capacity, dtype=torch.int32, device=dev)
    flag = torch.empty(capacity, dtype=torch.bool, device=dev)
    dropped = torch.empty((), dtype=torch.int32, device=dev)
    p = kernels.ptr
    kernels.launch("pack_indices", dev, p(mask), n, capacity, p(idx),
                   p(flag), p(dropped), p(_lookback(dev, n)))
    return idx, flag, dropped
