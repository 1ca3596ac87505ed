"""The least time the card could take (copied from ``chip_smoke.py``).

NVIDIA's H100 SXM data sheet: 3.35 TB/s of HBM3 and 67 TFLOP/s of float32
outside the tensor cores, at the full 700 W; a card set below that limit
runs slower, so every share is printed beside ``power.limit``.
"""

from __future__ import annotations

import dataclasses

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 operations of one pair test: 3 sub, 3 mul, 2 add, 1 compare.
PAIR_TEST_OPS = 9


def tensor_bytes(*items) -> int:
    """Bytes of the distinct tensors in ``items`` (tensors, dataclasses or
    tuples of them): each input read once, each output written once."""
    seen, total = set(), 0

    def walk(x):
        nonlocal total
        if isinstance(x, torch.Tensor):
            key = (x.data_ptr(), x.numel())
            if key not in seen:
                seen.add(key)
                total += x.numel() * x.element_size()
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)

    for item in items:
        walk(item)
    return total


def bound(nbytes: float, ops: float = 0.0) -> tuple:
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the float32 operations over the float32 rate."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")
