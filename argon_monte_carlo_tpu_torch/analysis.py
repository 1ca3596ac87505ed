"""Post-run analysis: distribution fits and mean-free-path statistics.

Port of ``argon_monte_carlo_tpu.analysis`` (numpy and scipy only; the
accumulators are read to the host).  Reference analogues:
* exponential decay fit of the total-free-path histogram, p0=[1.4e7,-1.1e7]
  (Open_Air_Cube_MC.py:119-121, 344-348) -- hard-sphere free paths must be
  exponential with rate 1/lambda;
* inverse power fit of the per-axis histograms (Open_Air_Cube_MC.py:123-125,
  357-381);
* mean-free-path report (Open_Air_Cube_MC.py:386-392).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .io.writers import histogram_densities, to_numpy


def fit_exp_function(x, coeff_1, coeff_2):
    """a * exp(b x) (Open_Air_Cube_MC.py:120-121)."""
    return coeff_1 * np.exp(coeff_2 * np.asarray(x))


def fit_inv_function(x, coeff_1, coeff_2, coeff_3):
    """a * (x - b)^c (Open_Air_Cube_MC.py:124-125)."""
    return coeff_1 * (np.asarray(x) - coeff_2) ** coeff_3


def fit_exponential(bin_edges: np.ndarray, densities: np.ndarray,
                    p0=(1.4e7, -1.1e7), maxfev: int = 25000):
    """Least-squares exponential fit; returns (a, b).

    Uses scipy.optimize.curve_fit when available (the reference's tool),
    otherwise a log-linear weighted least-squares fallback.
    """
    x = np.asarray(bin_edges, dtype=np.float64)
    y = np.asarray(densities, dtype=np.float64)
    try:
        from scipy.optimize import curve_fit

        popt, _ = curve_fit(fit_exp_function, x, y, p0=list(p0),
                            maxfev=maxfev)
        return float(popt[0]), float(popt[1])
    except ImportError:
        mask = y > 0
        if mask.sum() < 2:
            return float("nan"), float("nan")
        # log y = log a + b x, weighted by y (approximates LS on y).
        w = y[mask]
        A = np.stack([np.ones(mask.sum()), x[mask]], axis=1)
        coef = np.linalg.lstsq(A * w[:, None], np.log(w) * w, rcond=None)[0]
        return float(np.exp(coef[0])), float(coef[1])


def fit_inverse(bin_edges: np.ndarray, densities: np.ndarray,
                p0=(1.0, 0.0, -3.0), maxfev: int = 25000):
    """Inverse-power fit a(x-b)^c; returns (a, b, c) or NaNs without scipy."""
    try:
        from scipy.optimize import curve_fit

        popt, _ = curve_fit(fit_inv_function, np.asarray(bin_edges),
                            np.asarray(densities), p0=list(p0),
                            maxfev=maxfev)
        return tuple(float(v) for v in popt)
    except ImportError:
        return (float("nan"),) * 3
    except RuntimeError:
        return (float("nan"),) * 3


@dataclasses.dataclass(frozen=True)
class PathStatistics:
    """Mean free paths + fit parameters, the reference's end-of-run report."""

    mean_free_path: float
    mean_x_free_path: float
    mean_y_free_path: float
    mean_z_free_path: float
    num_completed_paths: int
    exp_fit_a: float
    exp_fit_b: float

    @property
    def fitted_mfp(self) -> float:
        """-1/b of the exponential fit: the distribution-level MFP."""
        return -1.0 / self.exp_fit_b if self.exp_fit_b else float("nan")


def path_statistics(measure, num_bins: int,
                    hist_range: tuple[float, float]) -> PathStatistics:
    """The report from a ``Measurements`` (tensors on any device)."""
    path_count = int(to_numpy(measure.path_count))
    count = max(path_count, 1)
    sums = to_numpy(measure.path_sum).astype(np.float64)
    edges, dens = histogram_densities(measure, num_bins, hist_range)
    a, b = fit_exponential(edges, dens[0])
    return PathStatistics(
        mean_free_path=float(sums[0] / count),
        mean_x_free_path=float(sums[1] / count),
        mean_y_free_path=float(sums[2] / count),
        mean_z_free_path=float(sums[3] / count),
        num_completed_paths=path_count,
        exp_fit_a=a,
        exp_fit_b=b,
    )
