"""K13: the pairs step between K3 and K4 -- the post-pairs recapture and the
dirty masks -- as one kernel.

``post_pairs`` runs the temperature pore's recapture after the pair
collisions, which particles it moved (``recap_p``), the speed after the
collisions, the bump, hot and dirty masks, the shared compaction's mask
and their counts (``kernels/csrc/post_pairs.cu``) for CUDA tensors, and
its plain twin ``post_pairs_plain`` for CPU tensors.  The twin is the
pairs step's own sequence of these stages, with the workload's
``post_pairs`` for the recapture: the pairs step runs it for every
workload without the kernel (the specular pore, with its audit and
nudge) and, with its lane masks, on every z-slab (the kernel takes no
masks).  Both return a ``PostPairs``.

The kernel updates ``state.pos`` (the rows it moves), ``plist.hot`` and
``plist.pending1`` in place and returns the objects it was given; the twin
returns new tensors for them and leaves its inputs alone.  ``state.pos``
is the step's own, which K8 updated in place before it (``Simulation.run``
copies its caller's state on entry), so no caller's tensor is written.
The kernel takes its constants from K8's ``PoreParams`` and recaptures
with K8's own code, so the two agree bitwise.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable, NamedTuple, Optional

import torch

from .. import kernels
from ..state import Measurements, ParticleState
from . import measure as measure_ops
from .pairs import PairList

if TYPE_CHECKING:  # pore_pass imports the engine, which imports this module
    from .pore_pass import PoreParams


class PostPairs(NamedTuple):
    """The pairs step's state after the post-pairs recapture, its pair list
    with the new ``hot`` and ``pending1`` cleared, the (N,) bool masks
    ``bump`` (speed changed or collided), ``dirty`` (to re-search) and
    ``shared`` (``pending_mask | dirty``: what the shared compaction
    takes), and four 0-d int32 counts: the recapture conditions taken
    (``oob_after_pairs``), ``pending1``'s set lanes before the clear
    (``latent_full``), the dirty lanes and the teleported ones (by either
    recapture)."""

    state: ParticleState
    plist: PairList
    bump: torch.Tensor
    dirty: torch.Tensor
    shared: torch.Tensor
    oob_after_pairs: torch.Tensor
    latent_full: torch.Tensor
    dirty_count: torch.Tensor
    teleports: torch.Tensor


def post_pairs_plain(recapture: Callable, state: ParticleState,
                     measure: Measurements, plist: PairList,
                     speed_pre: torch.Tensor, collided: torch.Tensor,
                     recap_w: torch.Tensor,
                     valid: Optional[torch.Tensor] = None,
                     local: Optional[torch.Tensor] = None) -> PostPairs:
    """The stages as plain PyTorch.  ``recapture(state) -> (state,
    count)`` (the workload's ``post_pairs``) returns new tensors where it
    moves a particle, so ``pos_pre`` still holds the positions before it.

    A z-slab passes its lane masks, ``valid`` (local and ghost lanes that
    hold a particle) and ``local`` (its own lanes among them), and a
    recapture that parks the invalid lanes; a ghost's ``speed_pre`` and
    ``recap_w`` are its owner's.  Then only valid lanes go bump, hot or
    dirty, ``oob_after_pairs`` counts the local lanes the recapture moved,
    and ``latent_full`` and ``teleports`` count local lanes only; the dirty
    count takes every valid lane, ghosts too."""
    pos_pre = state.pos
    state, oob_pairs = recapture(state)
    recap_p = torch.any(state.pos != pos_pre, dim=-1)
    # Dirty: speed changed, collided, teleported (hot for the rest of the
    # window) or queued at the rebuild (pending1).
    bump = (measure_ops.speed(state.vel) != speed_pre) | collided
    teleported = recap_w | recap_p
    pending1 = plist.pending1
    if valid is not None:
        oob_pairs = torch.sum(recap_p & local, dtype=torch.int32)
        bump = bump & valid
        teleported = teleported & valid
    hot = plist.hot | teleported
    dirty = bump | hot | pending1
    if valid is None:
        latent_full = torch.sum(pending1, dtype=torch.int32)
        teleports = torch.sum(teleported, dtype=torch.int32)
    else:
        dirty = dirty & valid
        latent_full = torch.sum(pending1 & local, dtype=torch.int32)
        teleports = torch.sum(teleported & local, dtype=torch.int32)
    plist = dataclasses.replace(plist, hot=hot,
                                pending1=torch.zeros_like(pending1))
    return PostPairs(
        state=state, plist=plist, bump=bump, dirty=dirty,
        shared=measure.pending_mask | dirty, oob_after_pairs=oob_pairs,
        latent_full=latent_full,
        dirty_count=torch.sum(dirty, dtype=torch.int32),
        teleports=teleports)


def post_pairs(state: ParticleState, measure: Measurements, plist: PairList,
               speed_pre: torch.Tensor, collided: torch.Tensor,
               recap_w: torch.Tensor, params: PoreParams,
               plain: Callable) -> PostPairs:
    """K13 (see the module docstring): one launch, in place on ``pos``,
    ``hot`` and ``pending1``; ``post_pairs_plain(plain, ...)`` runs for
    CPU tensors.  ``plain`` is the workload's recapture, ``params`` K8's
    constants."""
    pos = state.pos
    if kernels.use_plain(pos):
        return post_pairs_plain(plain, state, measure, plist, speed_pre,
                                collided, recap_w)
    dev = pos.device
    n = pos.shape[0]
    f32, b8 = torch.float32, torch.bool
    for t, name, dt, shape in [
        (pos, "pos", f32, (n, 3)), (state.vel, "vel", f32, (n, 3)),
        (speed_pre, "speed_pre", f32, (n,)), (collided, "collided", b8, (n,)),
        (recap_w, "recap_w", b8, (n,)), (plist.hot, "hot", b8, (n,)),
        (plist.pending1, "pending1", b8, (n,)),
        (measure.pending_mask, "pending_mask", b8, (n,)),
    ]:
        kernels.check(t, name, dt, shape, dev)
    prm, _ = params.on(dev)
    masks = torch.empty((3, n), dtype=b8, device=dev)
    counts = torch.empty(4, dtype=torch.int32, device=dev)
    p = kernels.ptr
    kernels.launch(
        "post_pairs", dev, p(pos), p(state.vel), p(speed_pre), p(collided),
        p(recap_w), p(plist.hot), p(plist.pending1), p(measure.pending_mask),
        p(prm), n, p(masks[0]), p(masks[1]), p(masks[2]), p(counts))
    return PostPairs(
        state=state, plist=plist, bump=masks[0], dirty=masks[1],
        shared=masks[2], oob_after_pairs=counts[0], latent_full=counts[1],
        dirty_count=counts[2], teleports=counts[3])
