"""Histogram figures matching the reference's matplotlib output (port of
``argon_monte_carlo_tpu.plotting``).

The reference shows a 4-subplot figure (total/x/y/z free-path histograms,
green bars, exponential fit overlay for the cube stage;
Open_Air_Cube_MC.py:340-384) and ships a standalone re-plot script with
the data hard-coded (graph_sim_data.py).  Here the same figure is built
from the accumulators or re-loaded from a run's saved files.  matplotlib
is imported inside the functions only.
"""

from __future__ import annotations

import os

import numpy as np

from . import analysis
from .io import writers

_AXIS_LABELS = (
    "Path length before collision (m)",
    "X Path length before collision (m)",
    "Y Path length before collision (m)",
    "Z Path length before collision (m)",
)


def histogram_figure(edges, densities, fit: bool = True, title: str = ""):
    """4-subplot free-path histogram figure (Open_Air_Cube_MC.py:340-384).

    edges: (num_bins,) left bin edges; densities: (4, num_bins).
    Returns the matplotlib Figure (the caller saves or shows it).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    width = edges[1] - edges[0] if len(edges) > 1 else 1.0
    fig, axes = plt.subplots(4, 1, figsize=(8, 16))
    labels = ("3d distance data", "x data", "y data", "z data")
    for i, ax in enumerate(axes):
        ax.bar(edges, densities[i], width=width, align="edge",
               color="green", label=labels[i])
        if fit and i == 0 and densities[0].max() > 0:
            a, b = analysis.fit_exponential(edges, densities[0])
            if np.isfinite(a) and np.isfinite(b):
                ax.plot(edges, analysis.fit_exp_function(edges, a, b),
                        "r--", label=f"fit: a={a:5.8f}, b={b:5.8f}")
        ax.set_xlabel(_AXIS_LABELS[i])
        ax.set_ylabel("Probability")
        ax.legend()
    if title:
        fig.suptitle(title)
    return fig


def replot_run(out_dir: str, save_to: str | None = None, fit: bool = True):
    """Rebuild the figure from a run directory's hist_*_data.txt files
    (the replacement for graph_sim_data.py's hard-coded arrays)."""
    edges = writers.read_reference_histogram(
        os.path.join(out_dir, "hist_x_axis_total_data.txt")
    )
    densities = np.stack([
        writers.read_reference_histogram(
            os.path.join(out_dir, f"hist_y_axis_{name}_data.txt")
        )
        for name in writers.AXIS_NAMES
    ])
    fig = histogram_figure(edges, densities, fit=fit,
                           title=os.path.basename(os.path.abspath(out_dir)))
    if save_to is None:
        save_to = os.path.join(out_dir, "histograms.png")
    fig.savefig(save_to, dpi=110, bbox_inches="tight")
    return save_to


def main(argv=None) -> int:
    """python -m argon_monte_carlo_tpu_torch.plotting <run_dir> [out.png]"""
    import sys

    args = argv if argv is not None else sys.argv[1:]
    if not args:
        print("usage: python -m argon_monte_carlo_tpu_torch.plotting "
              "<run_dir> [out.png]")
        return 2
    out = replot_run(args[0], args[1] if len(args) > 1 else None)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
