"""Which device holds each z-slab (port of ``parallel/mesh.make_mesh``).

The reference lays its slabs over a one-dimensional mesh of devices, one
slab a device.  The port is one process that holds a list of slabs, each
with its buffers on a device of its own choosing: with one card every slab
lives on it, with several the slabs are dealt over them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def make_devices(n_shards: Optional[int] = None,
                 devices: Optional[Sequence] = None) -> list[torch.device]:
    """The device of each of ``n_shards`` slabs, dealt round-robin over
    ``devices`` (default: every visible CUDA device; ``n_shards`` defaults
    to one slab a device).  Raises where no CUDA device is visible and none
    was named: the caller asks for the CPU with ``devices=["cpu"]``."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError(
                "no CUDA device is visible; pass devices=['cpu'] to run "
                "the slabs on the CPU")
        devices = [f"cuda:{i}" for i in range(count)]
    pool = []
    for dev in devices:
        dev = torch.device(dev)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        pool.append(dev)
    if not pool:
        raise ValueError("make_devices: an empty device list")
    if n_shards is None:
        n_shards = len(pool)
    if n_shards < 1:
        raise ValueError(f"n_shards={n_shards}: at least one slab")
    return [pool[s % len(pool)] for s in range(n_shards)]
