"""Band and index packing (K12): the masked lanes of a slab, in ascending
lane order, in a buffer of fixed size.

Port of ``_compact_band`` and ``_compact_idx`` of
``argon_monte_carlo_tpu.parallel.shard`` (shard.py:210-250).  The z-slab
engine packs its halo bands and its migrants with ``pack_band`` before each
exchange; ``pack_indices`` is the index-only form that the sharded pairs
mode freezes its export lists with.  Each launches its CUDA kernel
(``kernels/csrc/pack.cu``) for a CUDA mask and runs its plain version for a
CPU one.

Both rank the set lanes of ``mask`` by a prefix sum, keep the lanes with
``rank < capacity`` (those dropped are the highest lanes), and return a
``flag`` over the slots that were filled and ``dropped``, the number of set
lanes that did not fit.  An unfilled slot holds ``SENTINEL`` in the field
named ``pos`` (a far-away position that no search can reach), 0 in every
other field, and ``n`` in the index form.
"""

from __future__ import annotations

import math
import struct

import torch

from .. import kernels

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


def _scratch(n: int, dev):
    """(block_vals, block_offsets, total) of the kernel's scan."""
    nblocks = -(-n // 256)
    blocks = torch.empty((2, max(nblocks, 1)), dtype=torch.int32, device=dev)
    return blocks[0], blocks[1], torch.empty((), dtype=torch.int32,
                                             device=dev)


def pack_band(fields: dict, mask: torch.Tensor, capacity: int):
    """K12 (see ``pack_band_plain``); CUDA kernel for a CUDA mask.  The
    kernel takes up to ``MAX_FIELDS`` contiguous fields of float32, int32
    or bool."""
    if kernels.use_plain(mask):
        return pack_band_plain(fields, mask, capacity)
    dev = mask.device
    n = mask.shape[0]
    kernels.check(mask, "mask", torch.bool, (n,), dev)
    if len(fields) > MAX_FIELDS:
        raise ValueError(f"{len(fields)} fields; the kernel packs at most "
                         f"{MAX_FIELDS} in a launch")
    p = kernels.ptr
    buf, args = {}, []
    for name, arr in fields.items():
        if arr.dtype not in (torch.float32, torch.int32, torch.bool):
            raise TypeError(f"{name}: dtype {arr.dtype}, the kernel takes "
                            f"float32, int32 and bool")
        kernels.check(arr, name, arr.dtype, (n,) + tuple(arr.shape[1:]), dev)
        out = torch.empty((capacity,) + tuple(arr.shape[1:]),
                          dtype=arr.dtype, device=dev)
        buf[name] = out
        args += [p(arr), p(out),
                 math.prod(arr.shape[1:]) * arr.element_size(),
                 arr.element_size(), _fill_bits(name, arr.dtype)]
    null = kernels.optional_ptr(None)
    args += [null, null, 0, 0, 0] * (MAX_FIELDS - len(fields))
    flag = torch.empty(capacity, dtype=torch.bool, device=dev)
    dropped = torch.empty((), dtype=torch.int32, device=dev)
    kernels.launch("pack_band", dev, p(mask), n, capacity, len(fields),
                   *args, p(flag), p(dropped),
                   *(p(t) for t in _scratch(n, dev)))
    return buf, flag, dropped


def pack_indices(mask: torch.Tensor, capacity: int):
    """K12's index form (see ``pack_indices_plain``); CUDA kernel for a
    CUDA mask."""
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
                   p(flag), p(dropped), *(p(t) for t in _scratch(n, dev)))
    return idx, flag, dropped
