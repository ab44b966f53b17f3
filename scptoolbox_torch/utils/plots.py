"""Host-side plotting (reference src/utils/plots.jl, 890 LoC of matplotlib
wrappers). The solver path never touches this module; it consumes
finished `SCPSolution`/history objects (matching the reference's
post-solve plotting architecture, SURVEY.md section 2.7).

Components (reference file:line):
  plot_timeseries_bound  - shaded min/max bound bands      (plots.jl:63)
  plot_ellipsoids        - 2D projected obstacle slices    (plots.jl:125)
  plot_prisms            - 2D projected hyperrectangles    (plots.jl:163)
  plot_convergence       - log deviation-vs-iteration + solve-time
                           statistics across trials        (plots.jl:208-300)
  setup_axis             - shared axis cosmetics           (plots.jl:537)

The port's copy of `scptoolbox_tpu/utils/plots.py`. Matplotlib is
imported lazily, at the first plot: importing the package never needs it.
Arrays may be numpy arrays or tensors on any device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

# reference brand colors (src/utils/globals.jl:45-49)
BLUE = "#356397"
RED = "#db6245"
GREEN = "#5da9a1"
YELLOW = "#f1d46a"
DARK = "#26415d"


def as_numpy(a) -> np.ndarray:
    """A tensor on any device, or anything array-like, as numpy."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def generate_colormap(colors: Sequence[str] = (DARK, BLUE, GREEN, YELLOW),
                      name: str = "scp", n: int = 256):
    """Linear colormap through the brand colors (reference
    generate_colormap, plots.jl:658-700)."""
    from matplotlib.colors import LinearSegmentedColormap

    return LinearSegmentedColormap.from_list(name, list(colors), N=n)


def rgb2pyplot(rgb, alpha: float = 1.0):
    """(r, g, b) in 0..255 -> matplotlib rgba tuple (reference rgb/rgb2pyplot
    color helpers, plots.jl:700-760)."""
    r, g, b = rgb
    return (r / 255.0, g / 255.0, b / 255.0, alpha)


def darken(color: str, fraction: float):
    """Darken a named/hex color by `fraction` in [0, 1] (reference
    darken_color, scene_3d.jl shading helper)."""
    from matplotlib.colors import to_rgb

    return tuple((1.0 - fraction) * v for v in to_rgb(color))


def setup_axis(ax, *, xlabel: str = "", ylabel: str = "",
               title: str = "", grid: bool = True, axis_equal: bool = False):
    """Shared axis cosmetics (reference setup_axis!, plots.jl:537-641)."""
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    if title:
        ax.set_title(title)
    if grid:
        ax.grid(True, alpha=0.3, linewidth=0.5)
    if axis_equal:
        ax.set_aspect("equal", adjustable="datalim")
    return ax


def plot_timeseries_bound(ax, t, y_bound, *, max_y: Optional[float] = None,
                          color: str = RED, alpha: float = 0.15):
    """Shade the infeasible side of a scalar bound over time
    (reference plot_timeseries_bound!, plots.jl:63-110)."""
    t = as_numpy(t)
    y = np.broadcast_to(as_numpy(y_bound).astype(float), t.shape)
    top = max_y if max_y is not None else float(np.max(y)) * 1.2 + 1.0
    ax.fill_between(t, y, top, color=color, alpha=alpha, linewidth=0)
    ax.plot(t, y, color=color, linewidth=1.0, linestyle="--")
    return ax


def plot_ellipsoids(ax, ellipsoids: Sequence, *, axes=(0, 1),
                    color: str = RED, alpha: float = 0.5, n: int = 100):
    """Draw 2D projections of ellipsoid obstacles
    (reference plot_ellipsoids!, plots.jl:125-160)."""
    th = np.linspace(0.0, 2.0 * np.pi, n)
    circ = np.stack([np.cos(th), np.sin(th)])
    for E in ellipsoids:
        Ep = E.project(list(axes)) if hasattr(E, "project") else E
        H = as_numpy(Ep.H)
        c = as_numpy(Ep.c)
        # boundary {x : ||H (x - c)|| = 1}
        pts = np.linalg.pinv(H) @ circ + c[:, None]
        ax.fill(pts[0], pts[1], color=color, alpha=alpha, linewidth=0)
        ax.plot(pts[0], pts[1], color=color, linewidth=1.0)
    return ax


def plot_prisms(ax, prisms: Sequence, *, axes=(0, 1), color: str = GREEN,
                alpha: float = 0.3):
    """Draw 2D projections of hyperrectangles (reference plot_prisms!,
    plots.jl:163-205)."""
    import matplotlib.patches as mpatches

    i, j = axes
    for H in prisms:
        l = as_numpy(H.l)
        u = as_numpy(H.u)
        ax.add_patch(mpatches.Rectangle(
            (l[i], l[j]), u[i] - l[i], u[j] - l[j],
            facecolor=color, alpha=alpha, edgecolor=color, linewidth=1.0))
    return ax


def plot_convergence(histories, name: str = "problem", *,
                     path: Optional[str] = None):
    """Convergence + runtime statistics across trials (reference
    plot_convergence, plots.jl:208-300): log-scale per-iteration deviation
    ||X_l - X*|| / ||X*|| of every trial, plus a per-iteration cumulative
    solve-time percentile band when more than one trial is given.

    `histories` is one history (list of IterationRecord) or a list of them.
    Returns the matplotlib figure; saves to `path` when given.
    """
    plt = _plt()
    if histories and not isinstance(histories[0], (list, tuple)):
        histories = [histories]

    fig, axes = plt.subplots(
        1, 2 if len(histories) > 1 else 1, figsize=(9, 3.5), squeeze=False)
    ax = axes[0][0]

    for hist in histories:
        flat = lambda rec: np.concatenate(
            [as_numpy(a).ravel() for a in (rec.x, rec.u, rec.p)])
        X_last = flat(hist[-1])
        nrm = max(float(np.linalg.norm(X_last)), 1e-15)
        dev = []
        for rec in hist[:-1]:
            X = flat(rec)
            dev.append(np.linalg.norm(X - X_last) / nrm)
        if dev:
            ax.semilogy(np.arange(1, len(dev) + 1), np.maximum(dev, 1e-16),
                        color=BLUE, alpha=0.7, linewidth=1.0)
    setup_axis(ax, xlabel="iteration",
               ylabel=r"$\|X_\ell - X^*\| / \|X^*\|$",
               title=f"{name}: convergence")

    if len(histories) > 1:
        ax2 = axes[0][1]
        n_iter = min(len(h) for h in histories)
        times = np.asarray(
            [[h[i].timing.get("total", 0.0) for i in range(n_iter)]
             for h in histories])
        cum = np.cumsum(times, axis=1)
        med = np.percentile(cum, 50, axis=0)
        lo = np.percentile(cum, 10, axis=0)
        hi = np.percentile(cum, 90, axis=0)
        it = np.arange(1, n_iter + 1)
        ax2.fill_between(it, lo, hi, color=BLUE, alpha=0.2, linewidth=0)
        ax2.plot(it, med, color=BLUE, linewidth=1.5)
        setup_axis(ax2, xlabel="iteration", ylabel="cumulative time [s]",
                   title=f"{name}: solve time ({len(histories)} trials)")

    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=150)
    return fig


def plot_trajectory_2d(sol, *, axes=(0, 1), obstacles: Sequence = (),
                       prisms: Sequence = (), name: str = "trajectory",
                       path: Optional[str] = None):
    """Planar position trace with discrete nodes, continuous replay, and
    environment geometry (the shape shared by every example's
    plot_final_trajectory)."""
    plt = _plt()
    i, j = axes
    fig, ax = plt.subplots(figsize=(5, 5))
    if prisms:
        plot_prisms(ax, prisms, axes=axes)
    if obstacles:
        plot_ellipsoids(ax, obstacles, axes=axes)
    if sol.x_cont is not None:
        xc = as_numpy(sol.x_cont)
        ax.plot(xc[:, i], xc[:, j], color=DARK, linewidth=1.2,
                label="continuous")
    xd = as_numpy(sol.xd)
    ax.plot(xd[:, i], xd[:, j], "o", color=BLUE, markersize=3.5,
            label="nodes")
    setup_axis(ax, xlabel=f"x[{i}]", ylabel=f"x[{j}]", title=name,
               axis_equal=True)
    ax.legend(loc="best", fontsize=8)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=150)
    return fig
