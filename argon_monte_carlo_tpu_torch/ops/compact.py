"""Index compaction: ascending indices of a mask's set entries.

Port of ``argon_monte_carlo_tpu.ops.compact.compact_indices``, plain
PyTorch only: the histogram flush's plain version uses it, and the CUDA
flush kernel takes each event's rank from its own prefix count instead.
The standalone compaction kernel (K6) arrives with the pairs engine.
"""

from __future__ import annotations

import torch


def compact_indices(mask: torch.Tensor, size: int,
                    fill_value: int) -> torch.Tensor:
    """Exactly ``jnp.nonzero(mask, size=size, fill_value=fill_value)[0]``:
    the lowest ``size`` set indices, ascending, padded with
    ``fill_value`` (int32)."""
    idx = torch.nonzero(mask).flatten()[:size].to(torch.int32)
    out = torch.full((size,), fill_value, dtype=torch.int32,
                     device=mask.device)
    out[: idx.shape[0]] = idx
    return out
