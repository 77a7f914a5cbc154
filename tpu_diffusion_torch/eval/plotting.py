"""Publication plotting + protein visualization.

The port's own copy of `tpu_diffusion/eval/plotting.py` (numpy, with
matplotlib imported where a figure is drawn; the port imports nothing of
the JAX package).

Rebuilds `amortised diffusion/src/evaluation/{plotstyle,plot_pipeline,
visualize}.py`: rc-param plot styling with LaTeX-textwidth figure sizing,
the distribution-comparison pipeline (per-statistic histograms, radar chart,
parallel coordinates) over sample_stats rows, and 3-D C-alpha structure /
trajectory rendering (GIFs via matplotlib's PillowWriter; the reference's
pymol renders have no pymol here).

All functions return matplotlib figures so they compose with
`MetricWriter.write_figures`.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

# LaTeX textwidths in inches (plotstyle.py:13-40)
TEXTWIDTHS = {"thesis": 5.9, "beamer": 4.8, "paper": 6.75}


def set_plotstyle(context: str = "paper"):
    """Publication rc params (plotstyle.py:41-266, no LaTeX engine here)."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    plt.rcParams.update({
        "figure.figsize": (TEXTWIDTHS.get(context, 6.75), 3.2),
        "font.size": 9,
        "axes.titlesize": 9,
        "axes.labelsize": 8,
        "legend.fontsize": 7,
        "xtick.labelsize": 7,
        "ytick.labelsize": 7,
        "axes.spines.top": False,
        "axes.spines.right": False,
        "figure.dpi": 150,
        "savefig.bbox": "tight",
    })


def _numeric_columns(rows: List[Dict]) -> List[str]:
    if not rows:
        return []
    cols = []
    for k in rows[0]:
        if k in ("id",):
            continue
        vals = [v for r in rows for v in [r.get(k)] if v is not None]
        # require at least one actual numeric value — an all-None column
        # is vacuously "numeric" otherwise and crashes ax.hist downstream
        if vals and all(isinstance(v, (int, float)) and np.isfinite(v)
                        for v in vals):
            cols.append(k)
    return cols


def distribution_comparison(sample_rows: List[Dict],
                            train_rows: Optional[List[Dict]] = None,
                            columns: Optional[Sequence[str]] = None):
    """Per-statistic histogram grid: samples vs training set
    (plot_pipeline.py:30-150)."""
    import matplotlib.pyplot as plt
    columns = list(columns or _numeric_columns(sample_rows))
    n = len(columns)
    ncol = min(4, max(n, 1))
    nrow = math.ceil(n / ncol)
    fig, axes = plt.subplots(nrow, ncol, figsize=(3 * ncol, 2.2 * nrow),
                             squeeze=False)
    for i, col in enumerate(columns):
        ax = axes[i // ncol][i % ncol]
        vals = [r[col] for r in sample_rows if col in r]
        ax.hist(vals, bins=20, alpha=0.6, density=True, label="samples")
        if train_rows:
            tvals = [r[col] for r in train_rows if col in r]
            if tvals:
                ax.hist(tvals, bins=20, alpha=0.5, density=True,
                        label="train")
        ax.set_title(col)
    for j in range(n, nrow * ncol):
        axes[j // ncol][j % ncol].axis("off")
    if train_rows:
        axes[0][0].legend()
    fig.tight_layout()
    return fig


def radar_chart(stats: Dict[str, float],
                reference: Optional[Dict[str, float]] = None):
    """Normalized radar/spider chart of summary stats
    (plot_pipeline.py radar)."""
    import matplotlib.pyplot as plt
    keys = sorted(k for k, v in stats.items()
                  if isinstance(v, (int, float)) and np.isfinite(v))
    if not keys:
        raise ValueError("no numeric stats to plot")
    angles = np.linspace(0, 2 * np.pi, len(keys), endpoint=False)
    scale = {k: max(abs(stats[k]),
                    abs(reference.get(k, 0.0)) if reference else 0.0, 1e-9)
             for k in keys}
    vals = [stats[k] / scale[k] for k in keys]
    fig, ax = plt.subplots(subplot_kw={"projection": "polar"},
                           figsize=(4.5, 4.5))
    ax.plot(np.append(angles, angles[0]), vals + [vals[0]],
            label="samples")
    ax.fill(np.append(angles, angles[0]), vals + [vals[0]], alpha=0.2)
    if reference:
        rvals = [reference.get(k, 0.0) / scale[k] for k in keys]
        ax.plot(np.append(angles, angles[0]), rvals + [rvals[0]],
                label="reference")
    ax.set_xticks(angles)
    ax.set_xticklabels(keys)
    ax.legend(loc="upper right", bbox_to_anchor=(1.3, 1.1))
    return fig


def parallel_coordinates(rows: List[Dict],
                         columns: Optional[Sequence[str]] = None,
                         color_by: Optional[str] = None):
    """Parallel-coordinates plot across statistics (plot_pipeline.py)."""
    import matplotlib.pyplot as plt
    columns = list(columns or _numeric_columns(rows))
    # keep only columns present in EVERY row (optional per-row stats like
    # novelty_tm_score may exist on a subset; r[c] would KeyError)
    columns = [c for c in columns
               if all(isinstance(r.get(c), (int, float)) for r in rows)]
    if not columns:
        fig, ax = plt.subplots()
        return fig
    data = np.array([[r[c] for c in columns] for r in rows], float)
    lo = data.min(0)
    hi = np.maximum(data.max(0) - lo, 1e-9)
    norm = (data - lo) / hi
    fig, ax = plt.subplots(figsize=(1.2 * len(columns) + 2, 3.2))
    cvals = None
    if color_by and color_by in columns:
        cvals = norm[:, columns.index(color_by)]
    for i, row in enumerate(norm):
        color = plt.cm.viridis(cvals[i]) if cvals is not None else None
        ax.plot(range(len(columns)), row, alpha=0.4, color=color)
    ax.set_xticks(range(len(columns)))
    ax.set_xticklabels(columns, rotation=30, ha="right")
    ax.set_ylabel("normalized")
    fig.tight_layout()
    return fig


def plot_structure(coords: np.ndarray, title: str = ""):
    """3-D C-alpha trace (visualize.py quick_vis)."""
    import matplotlib.pyplot as plt
    fig = plt.figure(figsize=(4, 4))
    ax = fig.add_subplot(projection="3d")
    ax.plot(coords[:, 0], coords[:, 1], coords[:, 2], "-o", markersize=2,
            linewidth=1)
    ax.set_title(title)
    ax.set_axis_off()
    return fig


def trajectory_gif(trajectory: np.ndarray, path: str, fps: int = 10,
                   stride: int = 1):
    """Animate a [T, N, 3] reverse-diffusion trajectory to a GIF
    (visualize.py:14-179)."""
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, PillowWriter
    traj = trajectory[::stride]
    fig = plt.figure(figsize=(4, 4))
    ax = fig.add_subplot(projection="3d")
    lim = float(np.nanmax(np.abs(traj))) or 1.0

    def frame(k):
        ax.clear()
        ax.set_xlim(-lim, lim)
        ax.set_ylim(-lim, lim)
        ax.set_zlim(-lim, lim)
        ax.set_axis_off()
        c = traj[k]
        ax.plot(c[:, 0], c[:, 1], c[:, 2], "-o", markersize=2, linewidth=1)
        ax.set_title(f"step {k * stride}")

    anim = FuncAnimation(fig, frame, frames=len(traj))
    anim.save(path, writer=PillowWriter(fps=fps))
    plt.close(fig)
    return path


def run_plot_pipeline(sample_rows: List[Dict], out_dir: str,
                      train_rows: Optional[List[Dict]] = None,
                      summary: Optional[Dict[str, float]] = None):
    """Write the standard figure set (plot_pipeline.py:200-315)."""
    os.makedirs(out_dir, exist_ok=True)
    set_plotstyle()
    figs = {"distributions": distribution_comparison(sample_rows,
                                                     train_rows)}
    if summary:
        numeric = {k: v for k, v in summary.items()
                   if isinstance(v, (int, float)) and np.isfinite(v)}
        if numeric:
            figs["radar"] = radar_chart(numeric)
    if len(sample_rows) > 1:
        figs["parallel"] = parallel_coordinates(sample_rows)
    paths = {}
    for name, fig in figs.items():
        p = os.path.join(out_dir, f"{name}.png")
        fig.savefig(p)
        paths[name] = p
    return paths


# ---------------------------------------------------------------------------
# Protein plot pipeline: the reference's named figure set over
# sample_stats.csv rows (plot_pipeline.py:30-298). Each plot overlays up to
# three populations — unconditional samples, conditional samples, and the
# training set ("CATH" in the reference) — as density histograms.
# ---------------------------------------------------------------------------

_POP_COLORS = {"samples": "#1b9e77", "cond": "#d95f02", "train": "#7570b3"}


def _col(rows: Optional[List[Dict]], key: str,
         lo: float = -np.inf, hi: float = np.inf) -> np.ndarray:
    if not rows:
        return np.empty(0)
    v = np.asarray([r[key] for r in rows
                    if isinstance(r.get(key), (int, float))
                    and np.isfinite(r[key])], float)
    return v[(v >= lo) & (v <= hi)]


def _overlay_hist(ax, sample_rows, train_rows, cond_rows, key,
                  lo=-np.inf, hi=np.inf, binwidth=None, bins=50):
    pops = (("samples", sample_rows), ("cond", cond_rows),
            ("train", train_rows))
    for label, rows in pops:
        vals = _col(rows, key, lo, hi)
        if not len(vals):
            continue
        if binwidth is not None and np.isfinite(lo) and np.isfinite(hi):
            edges = np.arange(lo, hi + binwidth, binwidth)
        else:
            edges = bins
        ax.hist(vals, bins=edges, density=True, alpha=0.65,
                color=_POP_COLORS[label], label=label)
    ax.legend(frameon=False)


def plot_mean_chain_distances(sample_rows, train_rows=None, cond_rows=None,
                              lo: float = 3.5, hi: float = 4.0):
    """Density of per-structure mean C-alpha distance over the reference's
    [3.5, 4.0] A window with 0.005 bins (plot_pipeline.py:30-49)."""
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots()
    _overlay_hist(ax, sample_rows, train_rows, cond_rows,
                  "ca_distance_mean", lo, hi, binwidth=0.005)
    ax.set_xlabel(r"Backbone mean C$_\alpha$-distance [$\AA$]")
    ax.set_xlim(lo, hi)
    return fig


def plot_mean_ca_angles(sample_rows, train_rows=None, cond_rows=None,
                        lo: float = 50.0, hi: float = 100.0):
    """Density of mean C-alpha angle over [50, 100] degrees, 2-degree bins
    (plot_pipeline.py:51-69)."""
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots()
    _overlay_hist(ax, sample_rows, train_rows, cond_rows, "ca_angle_mean",
                  lo, hi, binwidth=2.0)
    ax.set_xlabel(r"Backbone mean C$_\alpha$-angle [degrees]")
    ax.set_xlim(lo, hi)
    return fig


def plot_secondary_structure_usage(sample_rows, train_rows=None,
                                   cond_rows=None):
    """Stacked helix/sheet/coil usage bars with percentage labels
    (plot_pipeline.py:71-118)."""
    import matplotlib.pyplot as plt
    keys = ("helix_proportion", "sheet_proportion", "coil_proportion")
    pops = [("samples", sample_rows)]
    if cond_rows:
        pops.append(("cond", cond_rows))
    if train_rows:
        pops.append(("train", train_rows))
    usage = np.array([[float(np.mean(_col(rows, k))) if len(_col(rows, k))
                       else 0.0 for k in keys] for _, rows in pops])
    fig, ax = plt.subplots()
    xs = np.arange(len(pops))
    colors = [(1.0, 0.6, 0.6), (0.75, 0.75, 1.0), (0.8, 0.8, 0.8)]
    bottom = np.zeros(len(pops))
    for j, (label, color) in enumerate(zip(("Helix", "Sheet", "Coil"),
                                           colors)):
        ax.bar(xs, usage[:, j], bottom=bottom, label=label, color=color,
               width=0.6)
        for i in range(len(pops)):
            if usage[i, j] > 0.02:
                ax.text(xs[i], bottom[i] + usage[i, j] / 2,
                        f"{usage[i, j] * 100:.1f}%", ha="center",
                        va="center", fontsize=7)
        bottom += usage[:, j]
    ax.set_xticks(xs)
    ax.set_xticklabels([p for p, _ in pops])
    ax.set_ylim(0, 1.01)
    ax.set_yticks([])
    ax.legend(ncol=3, loc="lower left", bbox_to_anchor=(0.0, -0.3, 1.0, 0.1),
              mode="expand", borderaxespad=0.0)
    return fig


def plot_radius_of_gyration(sample_rows, train_rows=None, cond_rows=None):
    """Rg density histograms (plot_pipeline.py:120-134)."""
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots()
    _overlay_hist(ax, sample_rows, train_rows, cond_rows,
                  "radius_of_gyration", bins=50)
    ax.set_xlabel(r"Radius of gyration $R_g$")
    return fig


def plot_sphericity(sample_rows, train_rows=None, cond_rows=None):
    """Sphericity density histograms; the reference's misspelled
    `shpericality` CSV column is the contract (plot_pipeline.py:136-150)."""
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots()
    _overlay_hist(ax, sample_rows, train_rows, cond_rows, "shpericality",
                  bins=50)
    ax.set_xlabel("Sphericity (hull / sphere volume)")
    return fig


def plot_novelty(sample_rows, cond_rows=None,
                 metric: str = "novelty_tm_score"):
    """Novelty-metric histogram vs the closest training structure
    (plot_pipeline.py:204-217)."""
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots()
    _overlay_hist(ax, sample_rows, None, cond_rows, metric, bins=50)
    ax.set_xlabel(f"{metric} vs closest training structure")
    return fig


def plot_conditional_loss_vs_step(cond_loss_dir: str,
                                  scale: float = 15.0 ** 2):
    """Mean ± spread of the motif guidance loss over sampling steps, from
    the condloss_<i>.npy files `sample_protein` writes (the reference loads
    the same layout at plot_pipeline.py:170-202; scale un-does the 1/15
    coordinate scaling -> A^2). Returns (mse_fig, rmsd_fig)."""
    import matplotlib.pyplot as plt
    files = sorted(f for f in os.listdir(cond_loss_dir)
                   if f.startswith("condloss_") and f.endswith(".npy"))
    if not files:
        raise FileNotFoundError(f"no condloss_*.npy in {cond_loss_dir}")
    losses = [np.load(os.path.join(cond_loss_dir, f)) * scale
              for f in files]
    n = min(map(len, losses))
    arr = np.stack([l[:n] for l in losses])  # [S, T]
    steps = np.arange(1, n + 1)
    figs = []
    for name, data in (("Motif MSE [$\\AA^2$]", arr),
                       ("Motif RMSD [$\\AA$]", np.sqrt(arr))):
        fig, ax = plt.subplots()
        mean = data.mean(0)
        lo, hi = np.percentile(data, [25, 75], axis=0)
        ax.plot(steps, mean, color=_POP_COLORS["cond"])
        ax.fill_between(steps, lo, hi, alpha=0.25,
                        color=_POP_COLORS["cond"])
        ax.axhline(1.0, color="red", linestyle="--", linewidth=1)
        ax.set_xlabel("Sampling step $t$")
        ax.set_ylabel(name)
        figs.append(fig)
    return tuple(figs)


def ks_similarity(sample_rows, train_rows, key: str) -> float:
    """1 - two-sample Kolmogorov-Smirnov statistic (plot_pipeline.py:219-222),
    computed from the empirical CDFs directly (no scipy needed)."""
    a = np.sort(_col(sample_rows, key))
    b = np.sort(_col(train_rows, key))
    if not len(a) or not len(b):
        return float("nan")
    grid = np.concatenate([a, b])
    cdf_a = np.searchsorted(a, grid, side="right") / len(a)
    cdf_b = np.searchsorted(b, grid, side="right") / len(b)
    return 1.0 - float(np.max(np.abs(cdf_a - cdf_b)))


_RADAR_CATEGORIES = (
    ("Angles", "ca_angle_mean"),
    ("Distances", "ca_distance_mean"),
    ("SS Ratio", "helix_proportion"),
    ("Issues", "exceeds_canvas"),
    ("Sphericity", "shpericality"),
)


def plot_protein_radar(sample_rows, train_rows):
    """KS-similarity radar over the reference's five categories, SS Ratio
    averaged over helix/sheet/coil (plot_pipeline.py:231-255)."""
    import matplotlib.pyplot as plt
    labels = [l for l, _ in _RADAR_CATEGORIES]
    values = [ks_similarity(sample_rows, train_rows, k)
              for _, k in _RADAR_CATEGORIES]
    values[2] = float(np.nanmean(
        [values[2]] + [ks_similarity(sample_rows, train_rows, k)
                       for k in ("sheet_proportion", "coil_proportion")]))
    values = [0.0 if not np.isfinite(v) else v for v in values]
    angles = np.linspace(0, 2 * np.pi, len(labels), endpoint=False)
    fig, ax = plt.subplots(subplot_kw={"projection": "polar"},
                           figsize=(4.0, 4.0))
    closed_a = np.append(angles, angles[0])
    closed_v = values + values[:1]
    ax.plot(closed_a, closed_v, linewidth=1)
    ax.fill(closed_a, closed_v, alpha=0.1)
    ax.set_xticks(angles)
    ax.set_xticklabels(labels, fontsize=7, color="grey")
    ax.set_rlabel_position(0)
    ax.set_yticks([0.25, 0.5, 0.75])
    ax.set_yticklabels(["1/4", "1/2", "3/4"], fontsize=6, color="grey")
    ax.set_ylim(0, 1)
    return fig


def run_protein_plot_pipeline(sample_rows: List[Dict], plot_dir: str,
                              train_rows: Optional[List[Dict]] = None,
                              cond_rows: Optional[List[Dict]] = None,
                              cond_loss_dir: Optional[str] = None) -> Dict:
    """The reference's full named figure set (plot_pipeline.py:284-298):
    chain distances, SSE usage, angles, Rg, sphericity, radar, novelty when
    present, and conditional loss-vs-step when a data dir is given."""
    os.makedirs(plot_dir, exist_ok=True)
    set_plotstyle()
    figs = {
        "backbone_dist_mean": plot_mean_chain_distances(
            sample_rows, train_rows, cond_rows),
        "backbone_angle_mean": plot_mean_ca_angles(
            sample_rows, train_rows, cond_rows),
        "secondary_structure_usage": plot_secondary_structure_usage(
            sample_rows, train_rows, cond_rows),
        "radius_of_gyration": plot_radius_of_gyration(
            sample_rows, train_rows, cond_rows),
        "sphericity": plot_sphericity(sample_rows, train_rows, cond_rows),
    }
    if train_rows:
        figs["radar"] = plot_protein_radar(sample_rows, train_rows)
    if any(isinstance(r.get("novelty_tm_score"), (int, float))
           for r in sample_rows):
        figs["novelty_tm_score"] = plot_novelty(sample_rows, cond_rows)
    if cond_loss_dir and os.path.isdir(cond_loss_dir):
        try:
            mse_fig, rmsd_fig = plot_conditional_loss_vs_step(cond_loss_dir)
            figs["cond_loss_mse"] = mse_fig
            figs["cond_loss_rmsd"] = rmsd_fig
        except FileNotFoundError:
            pass
    paths = {}
    for name, fig in figs.items():
        p = os.path.join(plot_dir, f"{name}.png")
        fig.savefig(p)
        paths[name] = p
    import matplotlib.pyplot as plt
    plt.close("all")
    return paths


def _read_csv(path: str) -> List[Dict]:
    """Rows of a CSV, numbers as floats (`protein/evaluate.py:_read_csv`)."""
    import csv
    rows: List[Dict] = []
    with open(path, newline="") as f:
        for r in csv.DictReader(f):
            row: Dict = {}
            for k, v in r.items():
                try:
                    row[k] = float(v)
                except (TypeError, ValueError):
                    row[k] = v
            rows.append(row)
    return rows


def _protein_plot_main(argv=None):
    """CLI mirroring the reference's plot_pipeline entry (:300-316):
    sample/ref/cond CSVs in, a directory of figures out."""
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--sample_csv", required=True)
    p.add_argument("--ref_csv", default=None)
    p.add_argument("--cond_csv", default=None)
    p.add_argument("--plot_dir", required=True)
    p.add_argument("--cond_loss_dir", default=None)
    args = p.parse_args(argv)
    paths = run_protein_plot_pipeline(
        _read_csv(args.sample_csv), args.plot_dir,
        train_rows=_read_csv(args.ref_csv) if args.ref_csv else None,
        cond_rows=_read_csv(args.cond_csv) if args.cond_csv else None,
        cond_loss_dir=args.cond_loss_dir)
    for name, path in sorted(paths.items()):
        print(f"{name}: {path}")


if __name__ == "__main__":
    _protein_plot_main()
