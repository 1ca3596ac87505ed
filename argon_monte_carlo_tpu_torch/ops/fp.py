"""Floating-point helpers that keep the plain versions IEEE-exact."""

from __future__ import annotations

import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Square root, correctly rounded for float32 on every device.

    PyTorch's vectorized float32 sqrt on x86 CPUs misses the IEEE result
    by one ulp for ~17% of inputs, while the reference (XLA) and the CUDA
    kernels round exactly; one ulp in a grazing collision's discriminant
    grows to 1e-5 in the exchanged velocity.  On the CPU float32 therefore
    goes through float64, whose square root rounded back to float32 is the
    correctly rounded result (53 >= 2*24 + 2 bits).  CUDA's own sqrt is
    IEEE already.
    """
    if x.dtype == torch.float32 and x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a Python float ``c``, rounded as IEEE division.

    PyTorch on CUDA divides by a Python scalar as a multiplication by its
    reciprocal, one ulp off the quotient the reference (XLA) and the CUDA
    kernels compute -- enough to move a particle across a cell boundary.
    Dividing by a 0-d tensor on the same device takes the true division.
    """
    return x / torch.full((), c, dtype=x.dtype, device=x.device)
