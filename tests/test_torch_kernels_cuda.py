"""Each hand-written CUDA kernel against its plain PyTorch version on the
card (marked ``cuda``; skipped where no card is present).

Imports no JAX, so it also runs on a machine with the card and without
JAX; there, the JAX-importing conftest is skipped:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: integer outputs and staging exact; K10's and K3's state within
2 ulp (both sides round every operation once, IEEE; measured 0), both in
place, K10 also with a chain, self-partners and pairs split across a local
and a ghost lane, and replayed in a CUDA graph; K5 one launch, also
replayed in a CUDA graph over a longer old tail; K7's
path_sum within 1e-6 relative (block sums in another order); K8's state
within 2 ulp and its ledger within 1e-5 of sum|term| (chip_smoke.py states
why), in place bitwise its twin on copies, also with the audit and with
staging rows past the particles; K14 every output bitwise its twin's, in
place with staging rows past the particles and the audit; K11 exact, also with every particle in one z-slab, at the window's
edges and replayed in a CUDA graph; K7 in place, also over two calls and
replayed in a CUDA graph; K12's buffers bitwise, its flags and counts exact; K2
exact, also on its long-segment path and when replayed in a CUDA graph.  The
pairs engine's kernels, K8, K11, K12 and the z-slab arguments of K2, K9 and
K10, and the slab forms of K1, K5, K3 and K4, run ``chip_smoke.py``'s own
checks, untimed: the pore at 200k particles (cut in 4 z-slabs for K12, the
sharded sweep and the sharded pairs mode), the cube at its published
24,627.
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


def k10_case(device):
    cfg, gen, state, grid = setup(device)
    r = cfg.physics.collision_range
    _, table, pslot, _ = collide.bin_and_table(state.pos, grid)
    partner = collide.partner_sweep(state.pos, table, pslot, grid, r)
    state, meas = chip_smoke.k10_inputs(state, gen, 200)
    return cfg, gen, grid, state, meas, partner, r


def test_resolve_pairs_kernel(device):
    """K10 in place against its in-place twin, each on its own copy: the
    count, ok and staging exact, the state within 2 ulp, the lanes of no
    matched pair untouched, one launch."""
    _, _, _, state, meas, partner, r = k10_case(device)
    before = kernels.launch_counts["resolve_pairs"]
    _, _, count, _, _, _ = chip_smoke.check_k10_case("", state, meas,
                                                      partner, r)
    assert kernels.launch_counts["resolve_pairs"] == before + 1
    assert int(count) > 7


def test_resolve_pairs_kernel_hard_cases(device):
    """K10 with a chain k -> i <-> j, with self-partners and with matched
    pairs split between a local and a ghost lane each way."""
    _, _, _, state, meas, partner, r = k10_case(device)
    chip_smoke.check_k10_hard_cases(state, meas, partner, r, "")


def test_resolve_pairs_kernel_replays_in_a_cuda_graph(device):
    """One captured K10 launch replayed three times on moved positions,
    searched partners and redrawn staging."""
    cfg, gen, grid, state, meas, _, r = k10_case(device)

    def search(pos):
        _, table, pslot, _ = collide.bin_and_table(pos, grid)
        return collide.partner_sweep(pos, table, pslot, grid, r)

    chip_smoke.check_resolve_pairs_graph(state, meas, search, r, cfg.dt, gen,
                                         "")


@pytest.mark.parametrize("capacity", [measure_ops.FLUSH_CAPACITY, 1024,
                                      TARGET * 2])
def test_flush_hist_kernel(device, capacity):
    """K7's dense entry in place against its twin, each on its own copy,
    the staging within its contract (a row whose mask is clear is zero):
    over the capacity (the look-back's cut, events dropped at 1024) and
    under it."""
    _, gen, state, _ = setup(device)
    n = state.num_particles
    meas = chip_smoke.k7_staging(
        Measurements.zeros(200, torch.float32, n, device), gen, 0.05)
    got, _, _ = chip_smoke.check_k7_case("", meas, 200, 1e-6, capacity)
    if capacity == 1024:
        assert int(got.hist_drop_count) > 0


def test_flush_hist_kernel_in_place_calls_and_graph(device):
    """K7's dense entry on chip_smoke's cases: dense and sparse staging
    over and under the capacity, a slab's lanes at its own capacity, two
    calls in a row on the same tensors, and one launch captured in a CUDA
    graph and replayed three times."""
    cfg, gen, state, _ = setup(device)
    host_grid, _ = build_grids(amt.make_workload(cfg), device)
    meas = chip_smoke.k7_staging(
        Measurements.zeros(cfg.engine.num_bins, torch.float32,
                           state.num_particles, device), gen, 0.1)
    chip_smoke.check_flush_dense(meas, gen, cfg, host_grid, "", reps=0)


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
    """K5 at the configured pair capacity and at half the entries, and one
    captured launch replayed three times on shrinking lists (the pad
    overwrites the longer tail the replay before left)."""
    before = kernels.launch_counts["emit_pairs"]
    chip_smoke.check_emit_pairs(pairs_case, "", 0)
    # Two calls and the warm-up and capture of the graph: a launch each.
    assert kernels.launch_counts["emit_pairs"] == before + 4


def test_emit_pairs_kernel_is_one_launch_leaving_its_scratch_zero(
        pairs_case):
    """K5 at N not a multiple of its tile and at capacities 0 and 1: one
    launch a call, exact, the look-back scratch zero after each."""
    c = pairs_case
    n = c.n - 123
    gen = torch.Generator(device=c.dev).manual_seed(5)
    cands = torch.randint(-3, n, (n, c.pcfg.top_k), generator=gen,
                          device=c.dev, dtype=torch.int32).clamp(min=-1)
    flags = torch.rand((2, n), generator=gen, device=c.dev) < 0.01
    zero = torch.zeros((), dtype=torch.int32, device=c.dev)
    pslot = torch.randint(0, 2 * n, (n,), generator=gen, device=c.dev,
                          dtype=torch.int32)
    for m_cap in (0, 1, 1000, n * c.pcfg.top_k):
        args = (cands, pslot, flags[0], flags[1], zero, zero, zero, n, m_cap)
        before = kernels.launch_counts["emit_pairs"]
        got = pairs_ops.emit_pairs(*args)
        assert kernels.launch_counts["emit_pairs"] == before + 1
        for a, b in zip(got, pairs_ops.emit_pairs_plain(*args)):
            assert torch.equal(a, b)
        key = (c.dev.index or 0, torch.cuda.current_stream().cuda_stream)
        assert int(compact._scratch[key].abs().sum()) == 0


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


@pytest.mark.parametrize("audit", [False, True])
@pytest.mark.parametrize("extra_rows", [0, 4099])
def test_pore_advance_in_place_equals_its_twin_on_copies(device, audit,
                                                         extra_rows):
    """K8 in place against its plain twin run on copies: every output
    bitwise (the ledger within 1e-5 of sum|term|), the tensors given
    returned and updated, staging rows past the particles untouched."""
    chip_smoke.check_pore_advance_in_place("", particles=TARGET, audit=audit,
                                           extra_rows=extra_rows)


def test_pore_advance_kernel_with_the_audit(device):
    """K8's ten audit counts against the plain audit of the twin's
    post-wall state, and K8 with the audit bitwise K8 without it."""
    chip_smoke.check_pore_advance_audit("", particles=TARGET, steps=3,
                                        timed=False)


def test_specular_advance_kernel(device):
    """K14 against its plain twin on the specular pore's pairs slice: every
    output bitwise, the audit's counts equal, in place with staging rows
    past the particles untouched, with the audit bitwise without it."""
    before = kernels.launch_counts["specular_advance"]
    chip_smoke.check_specular_advance("", particles=TARGET, steps=4, reps=0,
                                      require_cases=False)
    assert kernels.launch_counts["specular_advance"] > before


def test_post_pairs_kernel(device):
    """K13 against its twin at 50k particles with planted escapes in every
    branch of the recapture: every output and the four counts bitwise, in
    place (pos, hot and pending1 the tensors given), two launches equal."""
    chip_smoke.check_post_pairs("", particles=50_000, reps=0)


def test_post_pairs_kernel_replays_in_a_cuda_graph(device):
    chip_smoke.check_post_pairs_graph("", particles=50_000)


def test_bin_and_table_kernel_on_the_cube_grid(device):
    chip_smoke.check_k2_cube("", reps=0)


def test_cube_on_cells_matches_allpairs_on_card(device):
    chip_smoke.compare_cube_cells_with_allpairs("", steps=20)


def test_allpairs_partner_kernel(device):
    """K11 at the cube's 24,627 particles, with all of them in one slab,
    with probe pairs at the window's edges and replayed in a CUDA graph:
    five calls, the captured one counted once."""
    before = kernels.launch_counts["allpairs_partner"]
    chip_smoke.check_allpairs("", sizes=(None,), reps=0)
    assert kernels.launch_counts["allpairs_partner"] == before + 5


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


def test_slab_forms_of_the_pairs_kernels(device):
    """K1, K5, K3 and K4 with their z-slab arguments (global ids, valid
    lanes, the slab's windows, the local mask) on the arguments the sharded
    pairs mode hands them for one of 4 slabs."""
    before = dict(kernels.launch_counts)
    out = chip_smoke.check_sharded_pairs_kernels("", particles=TARGET,
                                                 reps=0)
    assert set(out) == {"rebuild_sweep", "emit_pairs", "test_and_resolve",
                        "research_dirty"}
    for name in out:
        assert kernels.launch_counts[name] > before.get(name, 0), name


def test_sharded_pairs_on_card_matches_cpu(device):
    chip_smoke.check_sharded_pairs_against_cpu("", particles=TARGET)
