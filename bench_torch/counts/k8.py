"""K8, the pore's per-particle stage, restated for a form in place
(``chip_smoke.check_pore_advance``): pos, vel, paths and has_collided read
(41 bytes a particle), pos and paths written (the drift moves every
particle: 28), recap_w and speed_pre written (5); a wall case's lanes
also write vel, has_collided and their staging (30 bytes) and, energized,
read their uniforms (8).  At 999,999 particles: 74,024,594 bytes."""

from __future__ import annotations

from .roofline import bound

PER_PARTICLE = 41 + 28 + 5
PER_HIT = 30
PER_ENERGIZED = 8
# ~60 float32 operations a particle.
OPS_PER_PARTICLE = 60


def bytes_in_place(n: int, hits: int, energized: int) -> int:
    """``hits``: the lanes a step's wall cases take, all six; ``energized``:
    those of the thermal cases 3-6."""
    return n * PER_PARTICLE + PER_HIT * hits + PER_ENERGIZED * energized


def bound_ms(n: int, hits: int, energized: int) -> tuple:
    return bound(bytes_in_place(n, hits, energized), OPS_PER_PARTICLE * n)
