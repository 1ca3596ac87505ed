"""Index compaction (K6): ascending indices of a mask's set entries.

Port of ``argon_monte_carlo_tpu.ops.compact.compact_indices``
(compact.py:23-46).  ``compact_indices`` launches the CUDA kernel
(``kernels/csrc/compact.cu``) for a CUDA mask and runs the plain version
``compact_indices_plain`` for a CPU one.  The pairs engine compacts its
per-step dirty and staged particles with it, the z-slab engine a slab's
free lanes; K3 and K4 compact on the way inside their own kernels.

The kernel is one launch: a single-pass scan whose tiles hand their
totals on through a small status array.  That array is scratch the
wrapper keeps, one tensor for each (device, stream) that ever compacted,
grown on demand and never cleared: every call passes a generation number
larger than the last, and a status word of an earlier generation reads as
"not written yet".  The scratch assumes that the calls sharing it run one
after another, which holds on one stream; work on a second stream of the
same device gets a scratch of its own, so it is safe too.
"""

from __future__ import annotations

import torch

from .. import kernels

# Mask entries a block of the kernel takes (compact.cu kTile).
TILE = 4096
# A status word holds 30 bits of generation.
_GENERATIONS = 1 << 30
# (device index, stream handle) -> [scratch (int64), last generation].
_scratch: dict = {}


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


def _scratch_for(dev: torch.device, tiles: int):
    """The (scratch, generation) of this call on ``dev``'s current stream:
    1 + ``tiles`` zero-initialised 64-bit words (the ticket, a status word
    a tile) and the next generation.  A larger mask, or a generation
    counter about to wrap, takes a new zeroed tensor."""
    stream = (torch.cuda.current_stream(dev).cuda_stream
              if dev.type == "cuda" else 0)
    key = (dev.index, stream)
    entry = _scratch.get(key)
    if (entry is None or entry[0].shape[0] < tiles + 1
            or entry[1] + 1 >= _GENERATIONS):
        entry = _scratch[key] = [
            torch.zeros(max(2 * (tiles + 1), 1024), dtype=torch.int64,
                        device=dev), 0]
    entry[1] += 1
    return entry


def compact_indices(mask: torch.Tensor, size: int,
                    fill_value: int) -> torch.Tensor:
    """K6 (see ``compact_indices_plain``); CUDA kernel for a CUDA mask: one
    launch, no allocation but the output.  Its scratch is kept for each
    stream of each device (see the module's docstring), so consecutive
    calls on a stream, of any lengths, and calls on different streams are
    both right."""
    if kernels.use_plain(mask):
        return compact_indices_plain(mask, size, fill_value)
    dev = mask.device
    length = mask.shape[0]
    kernels.check(mask, "mask", torch.bool, (length,), dev)
    out = torch.empty(size, dtype=torch.int32, device=dev)
    scratch, generation = _scratch_for(dev, -(-length // TILE))
    p = kernels.ptr
    kernels.launch("compact", dev, p(mask), length, size, fill_value,
                   generation, p(out), p(scratch))
    return out
