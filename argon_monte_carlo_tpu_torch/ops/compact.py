"""Index compaction (K6): ascending indices of a mask's set entries.

Port of ``argon_monte_carlo_tpu.ops.compact.compact_indices``
(compact.py:23-46).  ``compact_indices`` launches the CUDA kernel
(``kernels/csrc/compact.cu``) for a CUDA mask and runs the plain version
``compact_indices_plain`` for a CPU one.  The pairs engine compacts its
per-step dirty and staged particles with it; K3 and K4 compact on the way
inside their own kernels with the same code.
"""

from __future__ import annotations

import torch

from .. import kernels


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


def compact_indices(mask: torch.Tensor, size: int,
                    fill_value: int) -> torch.Tensor:
    """K6 (see ``compact_indices_plain``); CUDA kernel for a CUDA mask."""
    if kernels.use_plain(mask):
        return compact_indices_plain(mask, size, fill_value)
    dev = mask.device
    length = mask.shape[0]
    kernels.check(mask, "mask", torch.bool, (length,), dev)
    out = torch.empty(size, dtype=torch.int32, device=dev)
    total = torch.empty((), dtype=torch.int32, device=dev)
    nblocks = -(-length // 256)
    scratch = torch.empty((2, nblocks), dtype=torch.int32, device=dev)
    p = kernels.ptr
    kernels.launch("compact", dev, p(mask), length, size, fill_value, p(out),
                   p(total), p(scratch[0]), p(scratch[1]))
    return out
