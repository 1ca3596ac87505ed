"""Index compaction (K6): ascending indices of a mask's set entries.

Port of ``argon_monte_carlo_tpu.ops.compact.compact_indices``
(compact.py:23-46).  ``compact_indices`` launches the CUDA kernel
(``kernels/csrc/compact.cu``) for a CUDA mask and runs the plain version
``compact_indices_plain`` for a CPU one.  The pairs engine compacts its
per-step dirty and staged particles with it, the z-slab engine a slab's
free lanes; K3 compacts on the way inside its own first launch, with the
same single-pass scan.

The kernel is one launch: a single-pass scan whose tiles hand their
totals on through a small status array.  That array is scratch the
wrapper keeps, one zeroed tensor for each (device, stream) that ever
compacted, grown on demand; the kernel leaves it all zero when it ends, so
the host passes nothing that changes from call to call and a launch
recorded in a CUDA graph replays correctly.  A scratch that a longer mask
outgrows is replaced but never freed (``_retired`` keeps it), so a graph
that recorded its address goes on replaying into memory nobody else is
given.  The scratch assumes that the
calls sharing it run one after another, which holds on one stream; work on
a second stream of the same device gets a scratch of its own, so it is
safe too.
"""

from __future__ import annotations

import torch

from .. import kernels

# Mask entries a block of the kernel takes (compact.cu kTile).
TILE = 4096
# (device index, stream handle) -> the look-back scratch of K6 and K3 (int64,
# zero between calls).
_scratch: dict = {}
# Scratches that a larger one replaced: kept for the life of the process,
# because a captured launch may still hold their address.
_retired: list = []


def compact_indices_plain(mask: torch.Tensor, size: int,
                          fill_value: int) -> torch.Tensor:
    """Exactly ``jnp.nonzero(mask, size=size, fill_value=fill_value)[0]``:
    the lowest ``size`` set indices, ascending, padded with
    ``fill_value`` (int32)."""
    idx = torch.nonzero(mask).flatten()[:size].to(torch.int32)
    out = torch.full((size,), fill_value, dtype=torch.int32,
                     device=mask.device)
    out[: idx.shape[0]] = idx
    return out


def stream_scratch(store: dict, dev: torch.device, size: int,
                   dtype: torch.dtype, fill) -> torch.Tensor:
    """The scratch in ``store`` of a call on ``dev``'s current stream: at
    least ``size`` elements of ``dtype``, all ``fill`` when allocated, and
    kept in the state the kernel documents between calls (the kernel
    restores it).  A call that needs more elements takes a new, larger
    tensor; the old one is retired, not freed, since a captured launch may
    replay into it.  Shared by K6, K3 and K7's compacted entry."""
    stream = (torch.cuda.current_stream(dev).cuda_stream
              if dev.type == "cuda" else 0)
    key = (dev.index, stream)
    scratch = store.get(key)
    if scratch is None or scratch.shape[0] < size:
        if scratch is not None:
            _retired.append(scratch)
        scratch = store[key] = torch.full((max(2 * size, 1024),), fill,
                                          dtype=dtype, device=dev)
    return scratch


def lookback_scratch(dev: torch.device, tiles: int) -> torch.Tensor:
    """The single-pass scan's scratch (``kernels/csrc/lookback.cuh``) of a
    call on ``dev``'s current stream: at least 1 + ``tiles`` 64-bit words
    (ticket and finished count, a status word a tile), zero when allocated
    and zero again after every call of K6 or K3, which share it (see
    ``stream_scratch``; a zero scratch that a captured launch still holds
    stays right)."""
    return stream_scratch(_scratch, dev, tiles + 1, torch.int64, 0)


def compact_indices(mask: torch.Tensor, size: int,
                    fill_value: int) -> torch.Tensor:
    """K6 (see ``compact_indices_plain``); CUDA kernel for a CUDA mask: one
    launch, no allocation but the output.  Its scratch is kept for each
    stream of each device (see the module's docstring), so consecutive
    calls on a stream, of any lengths, and calls on different streams are
    both right.

    Under a CUDA graph: the scratch is allocated with ``torch.zeros`` at the
    first call on a stream, which a capture would record into the graph's
    own memory pool.  Make one call on the capturing stream, with a mask at
    least as long, before the capture begins; the captured launch then
    reuses that scratch and replays correctly any number of times, also
    after later calls on the stream, of any length, outside the graph: a
    scratch is never freed, and a call that outgrows it takes a new one and
    leaves the old one to the graph."""
    if kernels.use_plain(mask):
        return compact_indices_plain(mask, size, fill_value)
    dev = mask.device
    length = mask.shape[0]
    kernels.check(mask, "mask", torch.bool, (length,), dev)
    out = torch.empty(size, dtype=torch.int32, device=dev)
    scratch = lookback_scratch(dev, -(-length // TILE))
    p = kernels.ptr
    kernels.launch("compact", dev, p(mask), length, size, fill_value,
                   p(out), p(scratch))
    return out
