"""What decides ``correct``: the program's first steps, taken through the
timed entry at the timed size, against the plain reference's.

Numbers compared (each against the limit a cell's ``limits/<cell>.json``
gives it; a number without a limit there is not compared):

- ``lanes_off_pct``: the share of particles, in %, whose state after the
  steps departs from the reference's: a position or a path accumulator
  off by more than 1e-3 collision ranges, a velocity by more than 1e-3 of
  Maxwell's scale sqrt(kT/m), ``has_collided`` different, or a value not
  finite;
- ``ledger_gap``: the widest gap, over momentum-z, hot and cold energy,
  of the steps' summed ledger from the reference's, over the sum of the
  reference's |value| a step (a per-step gap swings with the one
  particle a Verlet list's latency sends to a wall a step early);
- ``events_gap``: the gap in collisions plus wall hits and in completed
  paths, summed over the steps, over the reference's total of both;
- ``hist_gap``: the larger of the histogram's summed |count gap| over the
  reference's count and the widest relative gap of ``path_sum``;

and, of the steps after them (the window's and the traced slice's), which
no reference follows:

- ``dropped_per_million``: particles dropped from a full cell or from the
  collision search's capacity (the program's ``overflow_count``) and paths
  dropped from the histogram (``hist_drop_count``) in those steps, per
  million particle-steps (``harness.run_cell`` reads it).
"""

from __future__ import annotations

import math

import torch

POS_TOL = 1e-3      # of the collision range
VEL_TOL = 1e-3      # of sqrt(kT/m)


def _rel(gap: float, scale: float) -> float:
    if gap == 0.0:
        return 0.0
    if not math.isfinite(gap):
        return math.inf
    return gap / scale if scale > 0.0 else math.inf


def numbers(prog: dict, ref: dict, setup) -> dict:
    """``prog`` and ``ref``: dicts of pos, vel, paths, has_collided (on one
    device), hist (4, B+1), path_sum (4,), path_count, rows (steps, 4):
    momentum-z, hot energy, cold energy, collisions."""
    cr, vs = setup.cr, setup.gas.a_shape
    pos_p, pos_r = prog["pos"].double(), ref["pos"].double()
    off = ~(torch.isfinite(pos_p).all(1) & torch.isfinite(
        prog["vel"].double()).all(1) & torch.isfinite(
        prog["paths"].double()).all(1))
    off |= (pos_p - pos_r).abs().amax(1).nan_to_num(math.inf) > POS_TOL * cr
    off |= ((prog["paths"].double() - ref["paths"].double()).abs().amax(1)
            .nan_to_num(math.inf) > POS_TOL * cr)
    off |= ((prog["vel"].double() - ref["vel"].double()).abs().amax(1)
            .nan_to_num(math.inf) > VEL_TOL * vs)
    off |= prog["has_collided"] != ref["has_collided"]
    out = {"lanes_off_pct": 100.0 * float(off.double().mean())}

    rp = torch.tensor(prog["rows"], dtype=torch.float64)
    rr = torch.tensor(ref["rows"], dtype=torch.float64)
    ledger = 0.0
    for f in range(3):
        gap = abs(float(rp[:, f].sum() - rr[:, f].sum()))
        ledger = max(ledger, _rel(gap, float(rr[:, f].abs().sum())))
    out["ledger_gap"] = ledger

    ev_gap = (abs(float(rp[:, 3].sum() - rr[:, 3].sum()))
              + abs(int(prog["path_count"]) - int(ref["path_count"])))
    out["events_gap"] = _rel(ev_gap, float(rr[:, 3].sum())
                             + int(ref["path_count"]))

    hp, hr = prog["hist"].double().cpu(), ref["hist"].double().cpu()
    hist = _rel(float((hp - hr).abs().sum().nan_to_num(math.inf)),
                float(hr.sum()))
    sp, sr = prog["path_sum"].double().cpu(), ref["path_sum"].double().cpu()
    for k in range(sp.shape[0]):
        hist = max(hist, _rel(abs(float(sp[k] - sr[k])), abs(float(sr[k]))))
    out["hist_gap"] = hist
    return out


def judge(values: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit; a number that is not finite fails."""
    checked, ok = {}, True
    for name, spec in limits.items():
        v = values[name]
        checked[name] = {"value": v, "limit": spec["limit"]}
        if not (math.isfinite(v) and v <= spec["limit"]):
            ok = False
    return ok, checked
