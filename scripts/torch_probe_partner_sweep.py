#!/usr/bin/env python3
"""Probe of the port's two kernels on the cell-ordered walk, K9 (partner
sweep) and K1 (the pairs rebuild's sweep), on one NVIDIA GPU: the kernel's
time at the 1M-particle temperature pore for one run length of the walk;
each result is first held exactly against the plain version.

K9: at cell capacities 32 (auto), 24 and 8, and on one z-slab's lanes with
``ids``, ``valid`` and ``cell_window``.  K1 (second argument ``k1``): at the
pairs capacity 24 and at 8.

Run from the repository root, one process a variant (the kernels are built
with ``-DAMC_RUN_CELLS=<cells>``, into a library of their own):

    python3 scripts/torch_probe_partner_sweep.py 8
    python3 scripts/torch_probe_partner_sweep.py 4
    python3 scripts/torch_probe_partner_sweep.py 16
    python3 scripts/torch_probe_partner_sweep.py 8 k1

Prints the card's name and power limit first; times are the wrapper's,
CUDA events, mean of 20 calls, three times over.
"""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import argon_monte_carlo_tpu_torch as amt  # noqa: E402
import chip_smoke as cs  # noqa: E402
from argon_monte_carlo_tpu_torch import kernels  # noqa: E402
from argon_monte_carlo_tpu_torch.ops import collide  # noqa: E402


def timed(fn):
    return [cs.timed_ms(fn, 20) for _ in range(3)]


def probe_rebuild_sweep(cells: int, tag: str) -> int:
    """K1 at the pairs capacity and at 8, exact, then timed."""
    kernels.library()
    case = cs.pairs_case()
    reach, _ = cs.pairs_ops.reach_radii(
        case.state.vel, case.cr, case.dt, case.pcfg.rebuild_interval,
        0.5 * case.grid.cell_size)
    pos = case.state.pos
    for cap in (None, 8):
        grid = case.grid if cap is None else amt.engine.build_grids(
            amt.make_workload(cs.config(cell_capacity=cap, **cs.PAIRS)),
            case.dev)[1]
        _, table, pslot, overflow = collide.bin_and_table(pos, grid)
        args = (pos, reach, table, pslot, grid, case.pcfg.top_k)
        for name, a, b in zip(("cands", "unswept", "pos0", "reach0"),
                              collide.rebuild_sweep(*args),
                              collide.rebuild_sweep_plain(*args)):
            cs.exact(f"K1 {name} (capacity {grid.capacity})", a, b)
        ms = timed(lambda: collide.rebuild_sweep(*args))
        print(f"K1 run_cells={cells} capacity={grid.capacity}: exact, "
              f"{int(overflow)} over capacity, "
              f"{ms!r} ms at N={pos.shape[0]} {tag}")
    return 0


def main(argv) -> int:
    cells = int(argv[0]) if argv else collide.RUN_CELLS
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    kernels.NVCC_FLAGS.append(f"-DAMC_RUN_CELLS={cells}")
    collide.RUN_CELLS = cells
    collide.cell_runs.__defaults__ = (cells,)
    tag = f"[{cs.card_line()}]"
    print(cs.card_line())
    if argv[1:2] == ["k1"]:
        return probe_rebuild_sweep(cells, tag)
    kernels.library()
    dev = torch.device("cuda")
    cfg = cs.config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    state = cs.init_ops.init_pore(cfg, gen, dev)
    pos = state.pos + cfg.dt * state.vel
    r = cfg.physics.collision_range
    for cap in (None, 24, 8):
        grid = amt.engine.build_grids(
            amt.make_workload(cs.config(cell_capacity=cap)), dev)[1]
        _, table, pslot, overflow = collide.bin_and_table(pos, grid)
        got = collide.partner_sweep(pos, table, pslot, grid, r)
        cs.exact(f"K9 (capacity {grid.capacity})", got,
                 collide.partner_sweep_plain(pos, table, pslot, grid, r))
        ms = timed(lambda: collide.partner_sweep(pos, table, pslot, grid, r))
        print(f"K9 run_cells={cells} capacity={grid.capacity}: exact, "
              f"{grid.run_start.shape[0] - 1} runs, {int(overflow)} over "
              f"capacity, {ms!r} ms at N={pos.shape[0]} {tag}")
    case = cs.slab_case()
    grid = case.c.grid
    _, table, pslot, _ = collide.bin_and_table(case.pos, grid,
                                               valid=case.lanes)
    kw = dict(ids=case.ids, valid=case.lanes, cell_window=case.window)
    got = collide.partner_sweep(case.pos, table, pslot, grid, case.cr, **kw)
    cs.exact("K9 (slab)", got, collide.partner_sweep_plain(
        case.pos, table, pslot, grid, case.cr, **kw))
    ms = timed(lambda: collide.partner_sweep(case.pos, table, pslot, grid,
                                             case.cr, **kw))
    print(f"K9 run_cells={cells} on a slab's {case.pos.shape[0]} lanes with "
          f"ids, valid, cell_window: exact, {ms!r} ms {tag}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
