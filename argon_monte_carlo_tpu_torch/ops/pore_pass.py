"""K8 and K14: a pore's per-particle stage of a step as one kernel.

``pore_advance`` (K8, the temperature pore: ``kernels/csrc/pore_walls.cu``)
runs drift and path accrual, the six wall cases and the post-wall
recapture; ``specular_advance`` (K14, the specular pore:
``kernels/csrc/specular_walls.cu``) runs drift and path accrual, the six
specular wall cases and the v1 nudge.  Each launches its kernel for CUDA
tensors and runs the plain version -- the engine's unfused sequence,
composed by ``engine.advance_plain`` from the workload's wall pass and
post-wall fix -- for CPU tensors.  Both update the step's own ``pos``,
``vel``, ``paths``, ``has_collided`` and the first N rows of
``measure``'s staging in place (the kernel writes only what changes; the
plain version's new tensors are copied into them), return the objects
they were given,

    (state, measure, WallLedger, recaptured (), recap_w (N,), speed_pre (N,))

and, given a (10,) int32 ``missed``, add the missed-case audit's counts
(``models/base.pore_missed_case_audit`` on the post-wall state, before the
fix) to it in place: the kernel evaluates the predicates itself, the
plain version runs the audit between its wall pass and its fix.

The kernels take every constant of the plain version as a float32 rounded
once on the host from the same double (``PoreParams``,
``SpecularParams``), so the two agree bitwise (K8 up to the order of its
ledger's sums; K14's ledger floats are zero, as the plain version's).
K14's launch is the span ``amc/step/walls``, the plain pass's span.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .. import kernels
from ..engine import WallLedger
from ..state import Measurements, ParticleState
from ..trace import span

# K8's constants, in the order of ``enum Param`` in pore_recapture.cuh.
PARAM_NAMES = (
    "dt", "r_oa", "cr_oa", "cr_oa_rr", "h", "plane_cold", "plane_hot",
    "rc_sq", "e_cold", "e_hot", "alpha_coat", "alpha_gap", "mass",
    "half_mass", "gap_hi_m_ar", "gap_lo_p_ar", "cr_gap", "cr_gap_sq",
    "cr_gap_rr", "cr_pore", "cr_pore_sq", "cr_pore_rr", "cos_cone",
    "one_m_cos", "two_pi", "table_z_lo", "table_span", "z_inset",
    "h_m_z_inset", "r_oa_sq", "oah", "h_m_oah", "gap_r_sq", "gap_bottom",
    "gap_top",
)
# K14's constants, in the order of ``enum Param`` in specular_walls.cu.
SPECULAR_PARAM_NAMES = (
    "dt", "r_oa", "cr_oa", "cr_oa_rr", "h", "h_m_oah", "oah", "r_pore",
    "gap_side_top", "gap_lo", "gap_hi", "r_gap", "cr_gap", "cr_gap_rr",
    "cr_pore", "cr_pore_rr", "nudge", "r_oa_sq", "gap_r_sq", "rc_sq",
)
MAX_HORNER = 32


def _check_names(cls: str, values: dict, names: tuple) -> None:
    if set(values) != set(names):
        odd = sorted(set(values) ^ set(names))
        raise ValueError(f"{cls}: names {odd} missing or unknown")


def _float32(values: dict, names: tuple, device) -> torch.Tensor:
    return torch.tensor([values[k] for k in names], dtype=torch.float32,
                        device=device)


@dataclasses.dataclass
class PoreParams:
    """Host doubles of K8's constants (``values`` by name, see
    PARAM_NAMES) and the gap polynomial's coefficients, highest degree
    first; ``on(device)`` gives them as float32 tensors, made once a
    device."""

    values: dict
    horner: tuple
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        _check_names("PoreParams", self.values, PARAM_NAMES)
        if not 1 <= len(self.horner) <= MAX_HORNER:
            raise ValueError(f"{len(self.horner)} Horner coefficients; the "
                             f"kernel takes 1 to {MAX_HORNER}")

    def on(self, device: torch.device):
        if device not in self._cache:
            self._cache[device] = (
                _float32(self.values, PARAM_NAMES, device),
                torch.tensor(self.horner, dtype=torch.float32, device=device),
            )
        return self._cache[device]


@dataclasses.dataclass
class SpecularParams:
    """Host doubles of K14's constants (``values`` by name, see
    SPECULAR_PARAM_NAMES); ``on(device)`` gives them as a float32 tensor,
    made once a device."""

    values: dict
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        _check_names("SpecularParams", self.values, SPECULAR_PARAM_NAMES)

    def on(self, device: torch.device) -> torch.Tensor:
        if device not in self._cache:
            self._cache[device] = _float32(self.values, SPECULAR_PARAM_NAMES,
                                           device)
        return self._cache[device]


def _plain_in_place(state: ParticleState, measure: Measurements, uniforms,
                    plain: Callable, missed):
    """The CPU side of both wrappers: ``plain`` on the given objects, its
    new tensors copied into them (the first n staging rows)."""
    n = state.pos.shape[0]
    out = plain(state, measure, uniforms, missed=missed)
    for f in dataclasses.fields(state):
        getattr(state, f.name).copy_(getattr(out[0], f.name))
    for f in ("pending_vals", "pending_mask"):
        getattr(measure, f)[:n].copy_(getattr(out[1], f)[:n])
    return (state, measure) + tuple(out[2:])


def _in_place_inputs(state: ParticleState, measure: Measurements,
                     missed: Optional[torch.Tensor]) -> list:
    """The state and the first n staging rows as both kernels take them,
    (tensor, name, dtype, shape) each, checked; raises on anything else
    (``missed`` too)."""
    n = state.pos.shape[0]
    dev = state.pos.device
    rows = measure.pending_vals.shape[0]
    f32, b8 = torch.float32, torch.bool
    kernels.check(measure.pending_vals, "pending_vals", f32, (rows, 4), dev)
    kernels.check(measure.pending_mask, "pending_mask", b8, (rows,), dev)
    if rows < n:
        raise ValueError(f"pending_vals: {rows} rows for {n} particles")
    inputs = [
        (state.pos, "pos", f32, (n, 3)), (state.vel, "vel", f32, (n, 3)),
        (state.paths, "paths", f32, (n, 4)),
        (state.has_collided, "has_collided", b8, (n,)),
        (measure.pending_vals[:n], "pending_vals", f32, (n, 4)),
        (measure.pending_mask[:n], "pending_mask", b8, (n,)),
    ]
    for t, name, dt, shape in inputs:
        kernels.check(t, name, dt, shape, dev)
    for t, name, *_ in (inputs[2], inputs[4]):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: its rows must be 16-byte aligned")
    if missed is not None:
        kernels.check(missed, "missed", torch.int32, (10,), dev)
    return inputs


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
        return _plain_in_place(state, measure, uniforms, plain, missed)
    dev = pos.device
    inputs = _in_place_inputs(state, measure, missed)
    kernels.check(uniforms, "uniforms", torch.float32, (n, 2), dev)
    prm, horner = params.on(dev)
    recap_w = torch.empty(n, dtype=torch.bool, device=dev)
    speed_pre = torch.empty(n, dtype=torch.float32, device=dev)
    # The ledger's block partials: 3 x ceil(blocks / 1024) x 1024.
    block_ledger = torch.empty(3 * -(-n // (256 * 1024)) * 1024,
                               dtype=torch.float32, device=dev)
    ledger = torch.empty(3, dtype=torch.float32, device=dev)
    counts = torch.empty(3, dtype=torch.int32, device=dev)
    p = kernels.ptr
    kernels.launch(
        "pore_advance", dev, *(p(t) for t, *_ in inputs), p(uniforms),
        p(prm), p(horner), horner.numel(), n, p(recap_w), p(speed_pre),
        p(block_ledger), p(ledger), p(counts), kernels.optional_ptr(missed),
    )
    wall_ledger = WallLedger(momentum_z=ledger[0], energy_hot=ledger[1],
                             energy_cold=ledger[2], wall_hits=counts[0],
                             errs=counts[1])
    return state, measure, wall_ledger, counts[2], recap_w, speed_pre


def specular_advance(state: ParticleState, measure: Measurements,
                     uniforms: torch.Tensor, params: SpecularParams,
                     plain: Callable, missed: Optional[torch.Tensor] = None):
    """K14 (see the module docstring), as ``pore_advance`` takes and gives
    its arguments; the kernel reads no ``uniforms``.  The launch and its
    counts' zero fill are the span ``amc/step/walls``: two device ops a
    step."""
    pos = state.pos
    n = pos.shape[0]
    if kernels.use_plain(pos):
        return _plain_in_place(state, measure, uniforms, plain, missed)
    dev = pos.device
    inputs = _in_place_inputs(state, measure, missed)
    prm = params.on(dev)
    recap_w = torch.empty(n, dtype=torch.bool, device=dev)
    speed_pre = torch.empty(n, dtype=torch.float32, device=dev)
    p = kernels.ptr
    with span("amc/step/walls"):
        # Hits, errors and nudges, and the ledger's float zero (word 3).
        counts = torch.zeros(4, dtype=torch.int32, device=dev)
        kernels.launch(
            "specular_advance", dev, *(p(t) for t, *_ in inputs), p(prm), n,
            p(recap_w), p(speed_pre), p(counts),
            kernels.optional_ptr(missed))
    zero = counts[3:].view(torch.float32)[0]
    ledger = WallLedger(momentum_z=zero, energy_hot=zero, energy_cold=zero,
                        wall_hits=counts[0], errs=counts[1])
    return state, measure, ledger, counts[2], recap_w, speed_pre
