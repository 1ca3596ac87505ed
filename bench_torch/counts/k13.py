"""K13, the pairs step's post-pairs recapture and dirty masks, by the job
alone, whatever implements it: pos and vel read (24 bytes a particle),
speed_pre (4), collided, recap_w, hot and pending1 (4); hot, bump and dirty
written (3).  35 bytes a particle: 34,999,965 at 999,999 particles.  The
rows the recapture moves (a few a step) and the kernel's own extras -- the
staging mask it reads and the compaction's mask it writes -- do not
enter."""

from __future__ import annotations

from .roofline import bound

PER_PARTICLE = 24 + 4 + 4 + 3


def bytes_moved(n: int) -> int:
    return n * PER_PARTICLE


def bound_ms(n: int) -> tuple:
    return bound(bytes_moved(n))
