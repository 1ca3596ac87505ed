"""Floating-point helpers that keep the plain versions IEEE-exact."""

from __future__ import annotations

import numpy as np
import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Square root, correctly rounded on every device.

    PyTorch's vectorized sqrt on x86 CPUs misses the IEEE result by one
    ulp for ~17% of float32 and ~1% of float64 inputs, while the reference
    (XLA) and the CUDA kernels round exactly; one ulp in a grazing
    collision's discriminant grows to 1e-5 in the exchanged velocity, and
    one in a speed flips the pairs engine's bump mask.  On the CPU the
    root is therefore numpy's, which is the hardware's IEEE square root.
    CUDA's own sqrt is IEEE already.
    """
    if x.device.type == "cpu":
        return torch.as_tensor(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a Python float ``c``, rounded as IEEE division.

    PyTorch on CUDA divides by a Python scalar as a multiplication by its
    reciprocal, one ulp off the quotient the reference (XLA) and the CUDA
    kernels compute -- enough to move a particle across a cell boundary.
    Dividing by a 0-d tensor on the same device takes the true division.
    """
    return x / torch.full((), c, dtype=x.dtype, device=x.device)
