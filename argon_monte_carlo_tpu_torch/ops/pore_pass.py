"""K8: the temperature pore's per-particle stage of a step as one kernel.

``pore_advance`` runs drift and path accrual, the six wall cases and the
post-wall recapture (``kernels/csrc/pore_walls.cu``) for CUDA tensors, and
the plain version -- the engine's unfused sequence, composed by
``engine.advance_plain`` from the workload's wall pass and recapture --
for CPU tensors.  Both update the step's own ``pos``, ``vel``, ``paths``,
``has_collided`` and the first N rows of ``measure``'s staging in place
(the kernel writes only what changes; the plain version's new tensors are
copied into them), return the objects they were given,

    (state, measure, WallLedger, recaptured (), recap_w (N,), speed_pre (N,))

and, given a (10,) int32 ``missed``, add the missed-case audit's counts
(``models/base.pore_missed_case_audit`` on the post-wall state, before the
recapture) to it in place: the kernel evaluates the predicates itself, the
plain version runs the audit between its wall pass and its recapture.

The kernel takes every constant of the plain version as a float32 rounded
once on the host from the same double (``PoreParams``), so the two agree
bitwise up to the order of the ledger's sums.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .. import kernels
from ..engine import WallLedger
from ..state import Measurements, ParticleState

# The kernel's constants, in the order of ``enum Param`` in pore_walls.cu.
PARAM_NAMES = (
    "dt", "r_oa", "cr_oa", "cr_oa_rr", "h", "plane_cold", "plane_hot",
    "rc_sq", "e_cold", "e_hot", "alpha_coat", "alpha_gap", "mass",
    "half_mass", "gap_hi_m_ar", "gap_lo_p_ar", "cr_gap", "cr_gap_sq",
    "cr_gap_rr", "cr_pore", "cr_pore_sq", "cr_pore_rr", "cos_cone",
    "one_m_cos", "two_pi", "table_z_lo", "table_span", "z_inset",
    "h_m_z_inset", "r_oa_sq", "oah", "h_m_oah", "gap_r_sq", "gap_bottom",
    "gap_top",
)
MAX_HORNER = 32


@dataclasses.dataclass
class PoreParams:
    """Host doubles of the kernel's constants (``values`` by name, see
    PARAM_NAMES) and the gap polynomial's coefficients, highest degree
    first; ``on(device)`` gives them as float32 tensors, made once a
    device."""

    values: dict
    horner: tuple
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        if set(self.values) != set(PARAM_NAMES):
            odd = sorted(set(self.values) ^ set(PARAM_NAMES))
            raise ValueError(f"PoreParams: names {odd} missing or unknown")
        if not 1 <= len(self.horner) <= MAX_HORNER:
            raise ValueError(f"{len(self.horner)} Horner coefficients; the "
                             f"kernel takes 1 to {MAX_HORNER}")

    def on(self, device: torch.device):
        if device not in self._cache:
            self._cache[device] = (
                torch.tensor([self.values[k] for k in PARAM_NAMES],
                             dtype=torch.float32, device=device),
                torch.tensor(self.horner, dtype=torch.float32, device=device),
            )
        return self._cache[device]


def pore_advance(state: ParticleState, measure: Measurements,
                 uniforms: torch.Tensor, params: PoreParams,
                 plain: Callable, missed: Optional[torch.Tensor] = None):
    """K8 (see the module docstring); ``plain(state, measure, uniforms,
    missed=missed)`` runs for CPU tensors.  The staging planes may have
    more rows than the state (a slab's local and ghost lanes): the first n
    rows are the particles', the rest are left as they are.  Every caller
    owns what it hands in (``Simulation.run`` and ``ShardedSimulation.run``
    copy their caller's state and measurements on entry)."""
    pos = state.pos
    n = pos.shape[0]
    if kernels.use_plain(pos):
        out = plain(state, measure, uniforms, missed=missed)
        for f in dataclasses.fields(state):
            getattr(state, f.name).copy_(getattr(out[0], f.name))
        for f in ("pending_vals", "pending_mask"):
            getattr(measure, f)[:n].copy_(getattr(out[1], f)[:n])
        return (state, measure) + tuple(out[2:])
    dev = pos.device
    rows = measure.pending_vals.shape[0]
    f32, b8 = torch.float32, torch.bool
    kernels.check(measure.pending_vals, "pending_vals", f32, (rows, 4), dev)
    kernels.check(measure.pending_mask, "pending_mask", b8, (rows,), dev)
    if rows < n:
        raise ValueError(f"pending_vals: {rows} rows for {n} particles")
    inputs = [
        (pos, "pos", f32, (n, 3)), (state.vel, "vel", f32, (n, 3)),
        (state.paths, "paths", f32, (n, 4)),
        (state.has_collided, "has_collided", b8, (n,)),
        (measure.pending_vals[:n], "pending_vals", f32, (n, 4)),
        (measure.pending_mask[:n], "pending_mask", b8, (n,)),
        (uniforms, "uniforms", f32, (n, 2)),
    ]
    for t, name, dt, shape in inputs:
        kernels.check(t, name, dt, shape, dev)
    for t, name, *_ in (inputs[2], inputs[4]):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: its rows must be 16-byte aligned")
    if missed is not None:
        kernels.check(missed, "missed", torch.int32, (10,), dev)
    prm, horner = params.on(dev)
    recap_w = torch.empty(n, dtype=b8, device=dev)
    speed_pre = torch.empty(n, dtype=f32, device=dev)
    # The ledger's block partials: 3 x ceil(blocks / 1024) x 1024.
    block_ledger = torch.empty(3 * -(-n // (256 * 1024)) * 1024, dtype=f32,
                               device=dev)
    ledger = torch.empty(3, dtype=f32, device=dev)
    counts = torch.empty(3, dtype=torch.int32, device=dev)
    p = kernels.ptr
    kernels.launch(
        "pore_advance", dev, *(p(t) for t, *_ in inputs), p(prm), p(horner),
        horner.numel(), n, p(recap_w), p(speed_pre), p(block_ledger),
        p(ledger), p(counts), kernels.optional_ptr(missed),
    )
    wall_ledger = WallLedger(momentum_z=ledger[0], energy_hot=ledger[1],
                             energy_cold=ledger[2], wall_hits=counts[0],
                             errs=counts[1])
    return state, measure, wall_ledger, counts[2], recap_w, speed_pre
