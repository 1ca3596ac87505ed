"""Port vs reference: K6's plain version against ``jnp.nonzero(size=,
fill_value=)`` and the JAX package's ``compact_indices`` at the lengths the
single-pass kernel finds hard (one entry, just under a block of 256, one
past a tile of 4,096, a million and three: a ragged last tile and a ragged
last vector), with every, no and some entries set, at size 0 and sizes
below and above the count; and the wrapper's scratch bookkeeping (one
zeroed scratch a device and stream, a new zeroed one for a larger mask,
nothing passed that changes from call to call).

Tolerance: exact (integers).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from argon_monte_carlo_tpu.ops.compact import compact_indices as jcompact
from argon_monte_carlo_tpu_torch.ops import collide as tcollide
from argon_monte_carlo_tpu_torch.ops import compact as tcompact
from argon_monte_carlo_tpu_torch.ops import measure as tmeasure
from argon_monte_carlo_tpu_torch.ops import pairs as tpairs

LENGTHS = (1, 255, 4_097, 1_000_003)
FILLS = {"all-set": 1.0, "none-set": 0.0, "some-set": 0.3}


@pytest.mark.parametrize("fill", sorted(FILLS))
@pytest.mark.parametrize("length", LENGTHS)
def test_compact_indices_plain_matches_nonzero_at_hard_lengths(length, fill):
    rng = np.random.default_rng(length)
    mask = rng.random(length) < FILLS[fill]
    count = int(mask.sum())
    assert count == {"all-set": length, "none-set": 0}.get(fill, count)
    for size in (0, max(count // 2, 1), count + 7):
        want = jnp.nonzero(jnp.asarray(mask), size=size,
                           fill_value=length)[0]
        got = tcompact.compact_indices_plain(torch.from_numpy(mask), size,
                                             length)
        assert got.dtype == torch.int32 and got.shape == (size,)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if size > 0:
            np.testing.assert_array_equal(
                got.numpy(),
                np.asarray(jcompact(jnp.asarray(mask), size, length)))
        # Ascending, truncated to the lowest indices, padded with the fill.
        kept = min(count, size)
        np.testing.assert_array_equal(got.numpy()[:kept],
                                      np.flatnonzero(mask)[:kept])
        assert (got.numpy()[kept:] == length).all()


def test_compact_wrapper_takes_the_plain_version_on_the_cpu():
    mask = torch.tensor([False, True, True, False, True])
    before = dict(tcompact.kernels.launch_counts)
    got = tcompact.compact_indices(mask, 4, 5)
    assert got.tolist() == [1, 2, 4, 5]
    assert dict(tcompact.kernels.launch_counts) == before


def test_compact_scratch_generations(monkeypatch):
    """What the wrapper still decides on the host, now that the kernel
    keeps its scratch zeroed by itself and no generation number is passed:
    one zeroed scratch for each (device, stream), the same tensor call
    after call whatever the mask's length, and a new, larger zeroed one
    for a mask with more tiles than the scratch has words, the outgrown
    one kept alive for a captured launch that may hold its address."""
    monkeypatch.setattr(tcompact, "_scratch", {})
    monkeypatch.setattr(tcompact, "_retired", [])
    dev = torch.device("cpu")
    first = tcompact.lookback_scratch(dev, 245)
    assert first.dtype == torch.int64
    assert first.shape[0] >= 246 and int(first.abs().sum()) == 0
    assert tcompact.lookback_scratch(dev, 3) is first
    assert tcompact.lookback_scratch(dev, first.shape[0] - 1) is first
    assert tcompact._retired == []
    # More tiles than words: a larger scratch, zeroed.
    first.fill_(-1)
    larger = tcompact.lookback_scratch(dev, first.shape[0] + 5)
    assert larger is not first
    assert larger.shape[0] >= first.shape[0] + 6
    assert int(larger.abs().sum()) == 0
    assert len(tcompact._retired) == 1 and tcompact._retired[0] is first
    assert tcompact.lookback_scratch(dev, 3) is larger
    assert list(tcompact._scratch) == [(dev.index, 0)]
    # Another stream of the device has a scratch of its own.
    monkeypatch.setitem(tcompact._scratch, (dev.index, 7), first)
    assert tcompact.lookback_scratch(dev, 3) is larger
    assert len(tcompact._scratch) == 2
    # Nothing in the call changes from one call to the next.
    assert not hasattr(tcompact, "_GENERATIONS")
    sig = tcompact.kernels._SIGNATURES["compact"]
    src = (tcompact.kernels.CSRC / "compact.cu").read_text()
    assert "generation" not in src.split("AMC_EXPORT int amc_compact(")[1]
    assert len(sig) == 7


def test_compact_tile_matches_the_kernel_source():
    """The wrapper sizes the scratch by the kernel's tile."""
    src = (tcompact.kernels.CSRC / "compact.cu").read_text()
    assert "constexpr int kTileBytes = 16;" in src
    assert "constexpr int kTile = amc::kThreads * kTileBytes;" in src
    common = (tcompact.kernels.CSRC / "common.cuh").read_text()
    assert "constexpr int kThreads = 256;" in common
    assert tcompact.TILE == 256 * 16


@pytest.mark.parametrize("source,lines,constant", [
    ("test_resolve.cu", ("constexpr int kEntries = 4;",
                         "constexpr int kTile = amc::kThreads * kEntries;"),
     "K3_TILE"),
    ("flush_hist.cu", ("constexpr int kFlushBytes = 16;",
                       "constexpr int kFlushTile = amc::kThreads * "
                       "kFlushBytes;"),
     "FLUSH_TILE"),
    ("lookback.cuh", ("constexpr int kCountItems = 4;",
                      "constexpr int kCountTile = kThreads * kCountItems;"),
     "COUNT_SCAN_TILE"),
    ("compact.cu", ("constexpr int kEmitItems = 4;",
                    "constexpr int kEmitGroups = 4;",
                    "constexpr int kEmitStride = amc::kThreads * kEmitItems;",
                    "constexpr int kEmitTile = kEmitStride * kEmitGroups;"),
     "EMIT_TILE"),
])
def test_kept_scratch_is_sized_by_the_kernels_tiles(source, lines, constant):
    """K3, K7's compacted entry, the scan of counts of K2 and K11, and K5
    keep per-tile scratch (look-back words, block sums) sized by their wrappers
    from the kernels' tiles."""
    src = (tcompact.kernels.CSRC / source).read_text()
    for line in lines:
        assert line in src
    values = [line.split("= ")[1].rstrip(";") for line in lines]
    per_thread = math.prod(int(v) for v in values if v.isdigit())
    module = {"K3_TILE": tpairs, "FLUSH_TILE": tmeasure,
              "COUNT_SCAN_TILE": tcollide, "EMIT_TILE": tpairs}[constant]
    value = getattr(module, constant)
    assert value == 256 * per_thread
