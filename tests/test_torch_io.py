"""The port's user-facing files against the JAX package's: the 8
histogram files and ``momentum_energy.csv`` byte for byte, the readers on
the in-repo reference-format runs, the path statistics and fits, and the
metrics records.

Tolerances: files byte-equal; path statistics and fit parameters within
1e-12 relative; metrics records equal key for key (the wall-clock keys
excepted), the float sums to the bit.
"""

import io
import json
import os
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from argon_monte_carlo_tpu import analysis as janalysis
from argon_monte_carlo_tpu.io import metrics as jmetrics
from argon_monte_carlo_tpu.io import writers as jwriters
from argon_monte_carlo_tpu.state import StepMetrics as JStepMetrics
from argon_monte_carlo_tpu_torch import analysis as tanalysis
from argon_monte_carlo_tpu_torch.io import metrics as tmetrics
from argon_monte_carlo_tpu_torch.io import writers as twriters
from argon_monte_carlo_tpu_torch.state import StepMetrics

REPO = Path(__file__).resolve().parent.parent
RUNS = REPO / "runs"
NUM_BINS = 200
HIST_RANGE = (0.0, 1e-6)
WALL_CLOCK = ("time", "elapsed_s", "particle_steps_per_sec",
              "session_particle_steps_per_sec")


def accumulators(seed=0, empty_axis=False):
    """float32 (4, 201) histogram counts, path sums and a path count, as
    the engine's accumulators hold them."""
    rng = np.random.default_rng(seed)
    hist = np.zeros((4, NUM_BINS + 1), np.float32)
    hist[:, :NUM_BINS] = rng.poisson(
        np.exp(-np.arange(NUM_BINS) / 25.0) * 1000, (4, NUM_BINS))
    hist[:, NUM_BINS] = 7.0
    if empty_axis:
        hist[2] = 0.0
    path_sum = rng.uniform(1e-3, 2e-3, 4)
    return hist, path_sum, int(hist[0].sum())


@pytest.mark.parametrize("empty_axis", [False, True])
def test_histogram_files_byte_equal(tmp_path, empty_axis):
    hist, path_sum, count = accumulators(1, empty_axis)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jpaths = jwriters.write_histograms(types.SimpleNamespace(hist=hist),
                                       NUM_BINS, HIST_RANGE,
                                       str(tmp_path / "jax"))
    tpaths = twriters.write_histograms(
        types.SimpleNamespace(hist=torch.from_numpy(hist)), NUM_BINS,
        HIST_RANGE, str(tmp_path / "port"))
    assert [os.path.basename(p) for p in tpaths] == [
        os.path.basename(p) for p in jpaths]
    assert len(tpaths) == 8
    for jp, tp in zip(jpaths, tpaths):
        assert Path(tp).read_bytes() == Path(jp).read_bytes(), tp
    dens = twriters.read_reference_histogram(
        str(tmp_path / "port" / "hist_y_axis_total_data.txt"))
    assert (dens * 5e-9).sum() == pytest.approx(1.0, rel=1e-9)


def ledger(n=300, seed=2):
    """float32 per-step ledger columns with the values a writer must
    spell out: zeros of both signs, large, tiny and round numbers."""
    rng = np.random.default_rng(seed)
    m = (rng.standard_normal(n) * 1e-22).astype(np.float32)
    c = (-np.abs(rng.standard_normal(n)) * 1e-18).astype(np.float32)
    h = (rng.standard_normal(n) * 2e-19).astype(np.float32)
    m[:4] = [0.0, -0.0, 1.5, 1e16]
    c[:4] = [123456789.0, 1e-5, 1e-45, -3.0]
    return m, c, h


def test_momentum_csv_byte_equal_to_pandas(tmp_path):
    """The port writes the CSV without pandas; its bytes equal the JAX
    writer's, which writes through pandas' DataFrame.to_csv."""
    pytest.importorskip("pandas")
    m, c, h = ledger()
    jw = jwriters.write_momentum_energy_csv(m, c, h, str(tmp_path / "j.csv"))
    tw = twriters.write_momentum_energy_csv(torch.from_numpy(m), c, h,
                                            str(tmp_path / "t.csv"))
    assert Path(tw).read_bytes() == Path(jw).read_bytes()
    back = twriters.read_momentum_energy_csv(tw)
    assert back["index"].tolist() == list(range(len(m)))
    for name, col in zip(twriters.CSV_COLUMNS, (m, c, h)):
        np.testing.assert_array_equal(back[name], col.astype(np.float64))


@pytest.mark.parametrize("run", ["cube", "full_temperature_pore"])
def test_reads_the_reference_format_runs(run):
    """The in-repo runs in the reference's format: 200 left edges 5e-9
    apart, densities that integrate to 1."""
    edges = twriters.read_reference_histogram(
        str(RUNS / run / "hist_x_axis_total_data.txt"))
    np.testing.assert_array_equal(edges, jwriters.read_reference_histogram(
        str(RUNS / run / "hist_x_axis_total_data.txt")))
    assert edges.shape == (200,)
    assert edges[0] == 0.0 and edges[1] - edges[0] == pytest.approx(5e-9)
    for name in twriters.AXIS_NAMES:
        dens = twriters.read_reference_histogram(
            str(RUNS / run / f"hist_y_axis_{name}_data.txt"))
        assert dens.shape == (200,)
        assert (dens * 5e-9).sum() == pytest.approx(1.0, rel=1e-6)


def test_csv_round_trip_on_the_reference_run(tmp_path):
    """runs/full_temperature_pore/momentum_energy.csv (the JAX package's
    20,000-step run) reads back with its header and index, and the port's
    writer spells the values it read to the same bytes."""
    ref = RUNS / "full_temperature_pore" / "momentum_energy.csv"
    back = twriters.read_momentum_energy_csv(str(ref))
    assert ref.read_text().splitlines()[0] == ",Momentum,EnergyCold,EnergyHot"
    assert back["index"].tolist() == list(range(20_000))
    out = twriters.write_momentum_energy_csv(
        back["Momentum"], back["EnergyCold"], back["EnergyHot"],
        str(tmp_path / "again.csv"))
    assert Path(out).read_bytes() == ref.read_bytes()


def test_path_statistics_and_fits_equal_reference():
    hist, path_sum, count = accumulators(3)
    jm = types.SimpleNamespace(hist=hist, path_sum=path_sum,
                               path_count=np.int32(count))
    tm = types.SimpleNamespace(hist=torch.from_numpy(hist),
                               path_sum=torch.from_numpy(path_sum),
                               path_count=torch.tensor(count,
                                                       dtype=torch.int32))
    want = janalysis.path_statistics(jm, NUM_BINS, HIST_RANGE)
    got = tanalysis.path_statistics(tm, NUM_BINS, HIST_RANGE)
    assert got.num_completed_paths == want.num_completed_paths == count
    for f in ("mean_free_path", "mean_x_free_path", "mean_y_free_path",
              "mean_z_free_path", "exp_fit_a", "exp_fit_b", "fitted_mfp"):
        assert getattr(got, f) == pytest.approx(getattr(want, f),
                                                rel=1e-12), f

    x = np.arange(200) * 5e-9
    lam = 8e-8
    y = 1.0 / lam * np.exp(-x / lam)
    a, b = tanalysis.fit_exponential(x, y)
    ja, jb = janalysis.fit_exponential(x, y)
    assert (a, b) == pytest.approx((ja, jb), rel=1e-12)
    assert -1.0 / b == pytest.approx(lam, rel=1e-6)
    got_inv = tanalysis.fit_inverse(x[1:], y[1:])
    want_inv = janalysis.fit_inverse(x[1:], y[1:])
    np.testing.assert_allclose(got_inv, want_inv, rtol=1e-12)


def step_metrics(steps=7, seed=4):
    """One epoch's metrics on both sides from the same numpy arrays."""
    rng = np.random.default_rng(seed)
    arrays = {
        "momentum_z": rng.standard_normal(steps).astype(np.float32) * 1e-22,
        "energy_hot": rng.standard_normal(steps).astype(np.float32) * 1e-19,
        "energy_cold": rng.standard_normal(steps).astype(np.float32) * 1e-18,
        "missed_cases": rng.integers(0, 5, (steps, 10)).astype(np.int32),
    }
    for name in ("collisions", "wall_hits", "oob_after_walls",
                 "oob_after_pairs", "nonfinite", "rebuilt", "dirty_count",
                 "latent_full", "teleports", "latent_research"):
        arrays[name] = rng.integers(0, 1000, steps).astype(np.int32)
    port = StepMetrics(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    return JStepMetrics(**arrays), port, arrays


def test_metrics_records_equal_reference():
    jm, tm, arrays = step_metrics()
    want = jmetrics.MetricsLogger(stream=io.StringIO()).log_epoch(
        jm, 5000, 300)
    got_stream = io.StringIO()
    logger = tmetrics.MetricsLogger(stream=got_stream)
    got = logger.log_epoch(tm, 5000, 300)
    assert set(got) == set(want)
    for k in set(want) - set(WALL_CLOCK):
        assert got[k] == want[k], k
        assert type(got[k]) is type(want[k]), k
    assert json.loads(got_stream.getvalue()) == got
    host = tmetrics.epoch_to_host(tm)
    for k, v in arrays.items():
        np.testing.assert_array_equal(host[k], v)
        assert host[k].dtype == v.dtype, k
    # A dict of host arrays logs the same record.
    again = tmetrics.MetricsLogger(stream=io.StringIO()).log_epoch(
        host, 5000, 300)
    assert {k: again[k] for k in want if k not in WALL_CLOCK} == {
        k: want[k] for k in want if k not in WALL_CLOCK}
    assert tmetrics.device_memory_stats("cpu") == {}
    assert "device_memory" not in got


def test_resumed_logger_appends(tmp_path):
    path = str(tmp_path / "metrics.jsonl")
    _, tm, _ = step_metrics()
    for resume in (False, True):
        logger = tmetrics.MetricsLogger(path, resume=resume)
        logger.log_epoch(tm, 10, 0)
        logger.close()
    assert len(Path(path).read_text().splitlines()) == 2
    logger = tmetrics.MetricsLogger(path)
    logger.close()
    assert Path(path).read_text() == ""
