"""Reference-format output artifacts (port of
``argon_monte_carlo_tpu.io.writers``).

The reference writes, at the end of a run (Open_Air_Cube_MC.py:394-418,
Temperature_Pore_MC.py:902-933):

* 8 histogram text files ``hist_{x,y}_axis_{total,x,y,z}_data.txt`` --
  the 200 left bin edges and the density-normalized counts, each written
  as ``str(ndarray)`` (numpy repr with unlimited threshold);
* ``momentum_energy.csv`` -- a pandas DataFrame of per-step Momentum,
  EnergyCold, EnergyHot with the row index = timestep.

Both are written byte for byte as the reference's tools write them, from
numpy alone: the CSV holds what ``DataFrame.to_csv`` writes (each float as
``repr(float(x))``, an empty field for NaN), without pandas.  Densities come
from the accumulators read to the host: density = counts / (in_range_total
* bin_width), numpy.histogram(density=True) semantics.
"""

from __future__ import annotations

import math
import os

import numpy as np

AXIS_NAMES = ("total", "x", "y", "z")
CSV_COLUMNS = ("Momentum", "EnergyCold", "EnergyHot")


def to_numpy(a) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def histogram_densities(measure, num_bins: int,
                        hist_range: tuple[float, float]):
    """(edges (num_bins,), densities (4, num_bins)) from the accumulators
    (``measure.hist``, a tensor or an array)."""
    lo, hi = hist_range
    width = (hi - lo) / num_bins
    counts = to_numpy(measure.hist).astype(np.float64)[:, :num_bins]
    totals = counts.sum(axis=1, keepdims=True)
    totals = np.where(totals == 0.0, 1.0, totals)
    densities = counts / (totals * width)
    edges = lo + width * np.arange(num_bins)
    return edges, densities


def _ndarray_repr(arr: np.ndarray) -> str:
    """The reference's file format: str(ndarray) with no truncation
    (np.set_printoptions(threshold=sys.maxsize), Open_Air_Cube_MC.py:13)."""
    with np.printoptions(threshold=np.iinfo(np.int64).max):
        return str(arr)


def write_histograms(measure, num_bins: int, hist_range: tuple[float, float],
                     out_dir: str = ".") -> list[str]:
    """Write the 8 reference histogram text files; returns the paths."""
    edges, densities = histogram_densities(measure, num_bins, hist_range)
    paths = []
    for i, name in enumerate(AXIS_NAMES):
        px = os.path.join(out_dir, f"hist_x_axis_{name}_data.txt")
        py = os.path.join(out_dir, f"hist_y_axis_{name}_data.txt")
        with open(px, "w") as f:
            f.write(_ndarray_repr(edges))
        with open(py, "w") as f:
            f.write(_ndarray_repr(densities[i]))
        paths += [px, py]
    return paths


def _csv_float(x: float) -> str:
    """One float as pandas' to_csv writes it: the shortest repr, and an
    empty field for NaN."""
    return "" if math.isnan(x) else repr(x)


def write_momentum_energy_csv(momentum_z, energy_cold, energy_hot,
                              path: str = "momentum_energy.csv") -> str:
    """Per-step ledger CSV (Temperature_Pore_MC.py:928-933): the header
    ``,Momentum,EnergyCold,EnergyHot``, an integer index from 0, and the
    three columns as float64, the bytes ``DataFrame.to_csv`` writes."""
    cols = [to_numpy(c).astype(np.float64).tolist()
            for c in (momentum_z, energy_cold, energy_hot)]
    if len({len(c) for c in cols}) != 1:
        raise ValueError("momentum_z, energy_cold and energy_hot differ "
                         "in length")
    with open(path, "w", newline="") as f:
        f.write("," + ",".join(CSV_COLUMNS) + "\n")
        for i, row in enumerate(zip(*cols)):
            f.write(f"{i}," + ",".join(_csv_float(v) for v in row) + "\n")
    return path


def read_momentum_energy_csv(path: str) -> dict:
    """The ledger CSV back as {"index": int64 array, column: float64
    array}; an empty field reads as NaN."""
    with open(path) as f:
        header = f.readline().rstrip("\n").split(",")
        if header[0] != "" or tuple(header[1:]) != CSV_COLUMNS:
            raise ValueError(f"{path}: header {header}, expected "
                             f"{['', *CSV_COLUMNS]}")
        rows = [line.rstrip("\n").split(",") for line in f if line.strip()]
    out = {"index": np.array([int(r[0]) for r in rows], dtype=np.int64)}
    for k, name in enumerate(CSV_COLUMNS, start=1):
        out[name] = np.array([float(r[k]) if r[k] else math.nan
                              for r in rows], dtype=np.float64)
    return out


def read_reference_histogram(path: str) -> np.ndarray:
    """Parse a ``str(ndarray)``-format histogram file."""
    with open(path) as f:
        text = f.read()
    text = text.strip().lstrip("[").rstrip("]")
    return np.fromiter((float(t) for t in text.split()), dtype=np.float64)
