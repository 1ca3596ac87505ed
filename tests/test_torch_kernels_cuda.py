"""Each hand-written CUDA kernel against its plain PyTorch version on the
card (marked ``cuda``; skipped where no card is present).

Imports no JAX, so it also runs on a machine with the card and without
JAX; there, the JAX-importing conftest is skipped:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: integer outputs and staging exact; K10's and K3's state within
2 ulp (both sides round every operation once, IEEE; measured 0); K7's
path_sum within 1e-6 relative (block sums in another order); K8's state
within 2 ulp and its ledger within 1e-5 of sum|term| (chip_smoke.py states
why); K11 exact; K12's buffers bitwise, its flags and counts exact; K2
exact, also on its long-segment path and when replayed in a CUDA graph.  The
pairs engine's kernels, K8, K11, K12 and the z-slab arguments of K2, K9 and
K10 run ``chip_smoke.py``'s own checks, untimed: the pore at 200k
particles (cut in 4 z-slabs for K12 and the sharded sweep), the cube at its
published 24,627.
"""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

import argon_monte_carlo_tpu_torch as amt
from argon_monte_carlo_tpu_torch import kernels
from argon_monte_carlo_tpu_torch.engine import build_grids
from argon_monte_carlo_tpu_torch.init import init_pore
from argon_monte_carlo_tpu_torch.ops import collide, compact
from argon_monte_carlo_tpu_torch.ops import measure as measure_ops
from argon_monte_carlo_tpu_torch.ops import pairs as pairs_ops
from argon_monte_carlo_tpu_torch.state import Measurements

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.cuda

TARGET = 200_000


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def setup(device, capacity=None):
    cfg = amt.temperature_pore_config(
        engine=amt.EngineConfig(cell_capacity=capacity)).scaled_to(TARGET)
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    state = init_pore(cfg, gen, device)
    state = dataclasses.replace(state, pos=state.pos + cfg.dt * state.vel)
    _, grid = build_grids(amt.make_workload(cfg), device)
    return cfg, gen, state, grid


def ulps(a, b):
    def ordered(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


@pytest.mark.parametrize("capacity", [None, 8])
def test_bin_and_table_kernel(device, capacity):
    _, _, state, grid = setup(device, capacity)
    before = kernels.launch_counts["bin_and_table"]
    got = collide.bin_and_table(state.pos, grid)
    want = collide.bin_and_table_plain(state.pos, grid)
    assert kernels.launch_counts["bin_and_table"] == before + 1
    for a, b in zip(got, want):
        assert a.dtype == torch.int32 and torch.equal(a, b)
    if capacity == 8:
        assert int(got[3]) > 0


@pytest.mark.parametrize("capacity", [None, 8, 40])
def test_partner_sweep_kernel(device, capacity):
    """K9 at the auto capacity, at 8 (cells overflow) and at 40 (above a
    warp's 32 slots: the kernel's chunked staging loop)."""
    cfg, _, state, grid = setup(device, capacity)
    r = cfg.physics.collision_range
    _, table, pslot, overflow = collide.bin_and_table(state.pos, grid)
    before = kernels.launch_counts["partner_sweep"]
    got = collide.partner_sweep(state.pos, table, pslot, grid, r)
    want = collide.partner_sweep_plain(state.pos, table, pslot, grid, r)
    assert kernels.launch_counts["partner_sweep"] == before + 1
    assert torch.equal(got, want) and int((got >= 0).sum()) > 0
    if capacity == 8:
        # Particles beyond a full cell's row: no slot, no partner.
        assert int(overflow) > 0
        assert (got[pslot >= grid.num_cells * grid.capacity] == -1).all()


def test_resolve_pairs_kernel(device):
    cfg, gen, state, grid = setup(device)
    r = cfg.physics.collision_range
    n = state.num_particles
    _, table, pslot, _ = collide.bin_and_table(state.pos, grid)
    partner = collide.partner_sweep(state.pos, table, pslot, grid, r)
    u = torch.rand((n, 6), generator=gen, device=device)
    state = dataclasses.replace(state, paths=u[:, :4] * 2e-7,
                                has_collided=u[:, 4] < 0.6)
    meas = Measurements.zeros(200, torch.float32, n, device)
    meas = dataclasses.replace(meas, pending_vals=u[:, :4] * 1e-6,
                               pending_mask=u[:, 5] < 0.1)
    gs, gm, gc = collide.resolve_pairs(state, meas, partner, r)
    ws, wm, wc = collide.resolve_pairs_plain(state, meas, partner, r)
    assert int(gc) == int(wc) > 0
    assert torch.equal(gs.has_collided, ws.has_collided)
    assert torch.equal(gm.pending_mask, wm.pending_mask)
    assert torch.equal(gm.pending_vals, wm.pending_vals)
    for a, b in ((gs.pos, ws.pos), (gs.vel, ws.vel), (gs.paths, ws.paths)):
        assert ulps(a, b) <= 2


@pytest.mark.parametrize("capacity", [measure_ops.FLUSH_CAPACITY, 1024,
                                      TARGET * 2])
def test_flush_hist_kernel(device, capacity):
    _, gen, state, _ = setup(device)
    n = state.num_particles
    u = torch.rand((n, 5), generator=gen, device=device)
    meas = Measurements.zeros(200, torch.float32, n, device)
    meas = dataclasses.replace(
        meas, pending_vals=u[:, :4] * 1.2e-6, pending_mask=u[:, 4] < 0.05,
        path_sum=u[:4, 0].contiguous())
    got = measure_ops.flush_hist(meas, 200, 1e-6, capacity=capacity)
    want = measure_ops.flush_hist_plain(meas, 200, 1e-6, capacity=capacity)
    for f in ("hist", "path_count", "hist_drop_count", "pending_vals",
              "pending_mask"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    torch.testing.assert_close(got.path_sum, want.path_sum, rtol=1e-6,
                               atol=0)
    if capacity == 1024:
        assert int(got.hist_drop_count) > 0


@pytest.mark.parametrize("capacity", [None, 8])
def test_bin_and_table_kernel_long_segments_and_calls_in_a_row(device,
                                                                capacity):
    """K2 with a cell of more than 100 particles and with 20,000 in one
    cell (its long-segment path), and over calls in a row on different
    positions, its counts left zero between calls."""
    cfg, _, state, grid = setup(device, capacity)
    chip_smoke.check_bin_and_table_hard(state, [grid], cfg.dt, "")


def test_bin_and_table_kernel_replays_in_a_cuda_graph(device):
    """One captured K2 call replayed three times on moved positions."""
    cfg, _, state, grid = setup(device)
    chip_smoke.check_bin_and_table_graph(state.pos, state.vel, cfg.dt, grid,
                                         "")


def test_kernels_refuse_float64(device):
    cfg, _, state, grid = setup(device)
    with pytest.raises(TypeError):
        collide.bin_and_table(state.pos.double(), grid)


@pytest.fixture(scope="module")
def pairs_case():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return chip_smoke.pairs_case(TARGET)


@pytest.fixture(scope="module")
def plist(pairs_case):
    c = pairs_case
    return pairs_ops.rebuild(
        c.state, c.grid, c.pcfg, c.cr, c.dt,
        pairs_ops.PairList.init(c.n, c.grid, c.pcfg, torch.float32, c.dev))


def test_compact_kernel(pairs_case):
    """K6 at three densities, at lengths around its tile with every, no and
    some entries set, on an unaligned view and over 100 calls in a row."""
    before = kernels.launch_counts["compact"]
    chip_smoke.check_compact(pairs_case, "", 0)
    assert kernels.launch_counts["compact"] > before + 100


def test_compact_kernel_on_a_second_stream(device):
    """A second stream of the device compacts with a scratch of its own, so
    calls interleaved on two streams are both right."""
    gen = torch.Generator(device=device).manual_seed(11)
    u = torch.rand(300_000, generator=gen, device=device)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    outs = []
    for k in range(20):
        mask = u[: 1000 + 14_000 * k] < 0.05 * (1 + k % 5)
        outs.append((mask, compact.compact_indices(mask, 4096, u.shape[0])))
        with torch.cuda.stream(side):
            outs.append((mask, compact.compact_indices(mask, 512,
                                                       u.shape[0])))
    torch.cuda.synchronize()
    assert len(compact._scratch) >= 2
    for mask, out in outs:
        assert torch.equal(out, compact.compact_indices_plain(
            mask, out.shape[0], u.shape[0]))


def test_compact_kernel_replays_in_a_cuda_graph(device):
    """One captured launch, replayed three times with the mask changed in
    between, after one call on the capturing stream allocated its scratch."""
    gen = torch.Generator(device=device).manual_seed(13)
    u = torch.rand(300_000, generator=gen, device=device)
    chip_smoke.check_compact_graph(u, 4096, "")


def test_rebuild_sweep_kernel(pairs_case):
    """K1 at the pairs capacity, with overflowing cells, with a cut active
    list and with rows that saturate top_k."""
    before = kernels.launch_counts["rebuild_sweep"]
    chip_smoke.check_rebuild_sweep(pairs_case, "", 0)
    assert kernels.launch_counts["rebuild_sweep"] == before + 4


def test_emit_pairs_kernel(pairs_case):
    chip_smoke.check_emit_pairs(pairs_case, "", 0)


def test_test_and_resolve_kernel(pairs_case, plist):
    """K3 in place, at the configured event_capacity, at 64 and with
    reversed and repeated duplicate entries colliding."""
    before = kernels.launch_counts["test_and_resolve"]
    chip_smoke.check_test_and_resolve(pairs_case, plist, "", 0)
    assert kernels.launch_counts["test_and_resolve"] == before + 3


def test_test_and_resolve_kernel_replays_in_a_cuda_graph(pairs_case, plist):
    chip_smoke.check_test_and_resolve_graph(pairs_case, plist, "")


def test_research_dirty_kernel(pairs_case, plist):
    """K4 in place: as configured, with a small append budget, with the
    cursor near the list's end and with lists that fill."""
    _, (state, _, _) = chip_smoke.check_test_and_resolve(pairs_case, plist,
                                                         "", 0)
    before = kernels.launch_counts["research_dirty"]
    chip_smoke.check_research_dirty(pairs_case, plist, state, "", 0)
    # Four cases, one launch each.
    assert kernels.launch_counts["research_dirty"] == before + 4


def test_flush_hist_compacted_kernel(pairs_case, plist):
    _, (_, meas, _) = chip_smoke.check_test_and_resolve(pairs_case, plist,
                                                        "", 0)
    chip_smoke.check_flush_compacted(pairs_case, meas, "", 0)


def test_flush_hist_compacted_kernel_replays_in_a_cuda_graph(pairs_case,
                                                             plist):
    _, (_, meas, _) = chip_smoke.check_test_and_resolve(pairs_case, plist,
                                                        "", 0)
    chip_smoke.check_flush_compacted_graph(pairs_case, meas, "")


def test_pairs_engine_on_card_matches_cpu(device):
    chip_smoke.check_against_cpu("", narrowphase="pairs", rebuild_interval=5)


def test_pore_advance_kernel(device):
    before = kernels.launch_counts["pore_advance"]
    chip_smoke.check_pore_advance("", particles=TARGET, steps=4, reps=0)
    assert kernels.launch_counts["pore_advance"] > before


def test_allpairs_partner_kernel(device):
    before = kernels.launch_counts["allpairs_partner"]
    chip_smoke.check_allpairs("", sizes=(None,), reps=0)
    assert kernels.launch_counts["allpairs_partner"] == before + 1


def test_cube_on_card_matches_cpu(device):
    chip_smoke.check_against_cpu(
        "", cfg=chip_smoke.cube_config(3_000, steps_per_epoch=5),
        label="cube", steps=20)


def test_pack_and_slab_argument_kernels(device):
    """K12's three entries with room, truncated, empty and at capacity 0,
    the two-direction entry also without a neighbour on either side, all
    three replayed in a CUDA graph; and K2, K9 and K10 with ``valid``,
    ``ids``, ``cell_window`` and ``local_mask`` on one slab's local and
    ghost lanes."""
    before = dict(kernels.launch_counts)
    chip_smoke.check_slab("", particles=TARGET, reps=0)
    for name in ("pack_band", "pack_indices", "pack_band_pair",
                 "bin_and_table", "partner_sweep", "resolve_pairs"):
        assert kernels.launch_counts[name] > before.get(name, 0), name


def test_pack_band_refuses_float64(device):
    mask = torch.ones(8, dtype=torch.bool, device=device)
    rows = torch.zeros((8, 3), dtype=torch.float64, device=device)
    with pytest.raises(TypeError):
        chip_smoke.pack.pack_band({"pos": rows}, mask, 4)
    edge = torch.zeros((), dtype=torch.float64, device=device)
    with pytest.raises(TypeError):
        chip_smoke.pack.pack_band_pair({"pos": rows}, mask, 4, edge, edge)


def test_sharded_sweep_on_card_matches_cpu(device):
    chip_smoke.check_sharded_against_cpu("", particles=TARGET)
