"""Per-example plot suites (reference test/examples/*/plots.jl, eight
files of per-problem figure code; SURVEY.md §2.6). Each function consumes a
finished `SCPSolution` and renders the reference's figure set for that
problem — final trajectory with environment geometry, input timeseries with
bound shading, and problem-specific panels (tilt/thrust for the quadrotor,
attitude glyphs for the starship flip, impulse stem trains for the
rendezvous problems, a 3D scene render for the free-flyer).

The port's copy of `scptoolbox_tpu/utils/example_plots.py`. Everything is
host-side matplotlib (imported lazily, at the first plot) on numpy arrays
or tensors on any device; figures save to `{prefix}_<name>.png` when a
prefix is given and are returned for further composition."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from scptoolbox_torch.utils.plots import (BLUE, DARK, GREEN, RED, _plt,
                                          as_numpy, plot_timeseries_bound,
                                          plot_trajectory_2d, setup_axis)


def _save(fig, prefix: Optional[str], name: str):
    if prefix:
        fig.savefig(f"{prefix}_{name}.png", dpi=150)
    return fig


def _input_timeseries(t, u, labels, *, bounds=(), title="inputs"):
    """Stacked input panels with optional (value, color) bound lines."""
    plt = _plt()
    nu = u.shape[1]
    fig, axes = plt.subplots(nu, 1, figsize=(6, 1.8 * nu), squeeze=False,
                             sharex=True)
    for i in range(nu):
        ax = axes[i][0]
        ax.plot(t, u[:, i], color=BLUE, linewidth=1.2, marker="o",
                markersize=2.5)
        for b, color in bounds:
            ax.axhline(b, color=color, linestyle="--", linewidth=0.8)
        setup_axis(ax, ylabel=labels[i] if i < len(labels) else f"u[{i}]")
    axes[-1][0].set_xlabel("time")
    axes[0][0].set_title(title)
    fig.tight_layout()
    return fig


# ---------------------------------------------------------------------------


def plot_double_integrator(sol, *, prefix: Optional[str] = None):
    """Position/velocity phase portrait + acceleration trace (reference
    double_integrator/plots.jl)."""
    plt = _plt()
    fig, axes = plt.subplots(1, 2, figsize=(9, 3.5))
    t = as_numpy(sol.t_grid)
    xd, ud = as_numpy(sol.xd), as_numpy(sol.ud)
    axes[0].plot(xd[:, 0], xd[:, 1], "-o", color=BLUE, markersize=3)
    setup_axis(axes[0], xlabel="position", ylabel="velocity",
               title="phase portrait")
    axes[1].step(t, ud[:, 0], where="post", color=RED)
    setup_axis(axes[1], xlabel="time", ylabel="acceleration",
               title="control")
    fig.tight_layout()
    return _save(fig, prefix, "double_integrator")


def plot_rocket_landing(sol, *, prefix: Optional[str] = None):
    """Descent trajectory, thrust magnitude vs annulus bounds, and mass
    history (reference rocket_landing/plots.jl). Works on the LCvx result
    dict or an SCPSolution-like object with xd (r, v, log m) and ud."""
    plt = _plt()
    xd = as_numpy(sol.xd)
    ud = as_numpy(sol.ud)
    t = as_numpy(sol.t_grid)
    fig, axes = plt.subplots(1, 3, figsize=(12, 3.5))
    axes[0].plot(xd[:, 0], xd[:, 2] if xd.shape[1] > 2 else xd[:, 1],
                 "-o", color=BLUE, markersize=3)
    setup_axis(axes[0], xlabel="downrange", ylabel="altitude",
               title="descent", axis_equal=True)
    thr = np.linalg.norm(ud[:, :3], axis=1) if ud.shape[1] >= 3 else \
        np.abs(ud[:, 0])
    axes[1].plot(t, thr, "-o", color=RED, markersize=3)
    setup_axis(axes[1], xlabel="time", ylabel="||T||/m",
               title="thrust accel")
    if xd.shape[1] >= 7:
        axes[2].plot(t, np.exp(xd[:, 6]), color=GREEN)
        setup_axis(axes[2], xlabel="time", ylabel="mass", title="mass")
    fig.tight_layout()
    return _save(fig, prefix, "rocket_landing")


def plot_oscillator(sol, *, prefix: Optional[str] = None):
    """State decay + deadband control trace (reference
    oscillator/plots.jl: the deadband makes the control bang-coast)."""
    plt = _plt()
    t = as_numpy(sol.t_grid)
    xd, ud = as_numpy(sol.xd), as_numpy(sol.ud)
    fig, axes = plt.subplots(1, 2, figsize=(9, 3.5))
    axes[0].plot(t, xd[:, 0], color=BLUE, label="position")
    axes[0].plot(t, xd[:, 1], color=GREEN, label="velocity")
    axes[0].legend(fontsize=8)
    setup_axis(axes[0], xlabel="time", ylabel="state", title="decay")
    axes[1].step(t, ud[:, 0], where="post", color=RED)
    setup_axis(axes[1], xlabel="time", ylabel="control",
               title="deadband control")
    fig.tight_layout()
    return _save(fig, prefix, "oscillator")


def plot_quadrotor(sol, obstacles: Sequence = (), *,
                   tilt_max_deg: float = 60.0,
                   prefix: Optional[str] = None):
    """XY trajectory through the keep-out ellipsoids + tilt angle and
    acceleration magnitude vs their bounds (reference
    quadrotor/plots.jl)."""
    plt = _plt()
    fig1 = plot_trajectory_2d(sol, axes=(0, 1), obstacles=obstacles,
                              name="quadrotor trajectory")
    _save(fig1, prefix, "quadrotor_traj")

    t = as_numpy(sol.t_grid)
    ud = as_numpy(sol.ud)
    a = ud[:, :3]
    sig = ud[:, 3] if ud.shape[1] > 3 else np.linalg.norm(a, axis=1)
    tilt = np.degrees(np.arccos(np.clip(
        a[:, 2] / np.maximum(np.linalg.norm(a, axis=1), 1e-9), -1, 1)))
    fig, axes = plt.subplots(1, 2, figsize=(9, 3.5))
    axes[0].plot(t, tilt, "-o", color=BLUE, markersize=3)
    plot_timeseries_bound(axes[0], t, tilt_max_deg, max_y=90.0)
    setup_axis(axes[0], xlabel="time", ylabel="tilt [deg]", title="tilt")
    axes[1].plot(t, np.linalg.norm(a, axis=1), "-o", color=BLUE,
                 markersize=3, label="||a||")
    axes[1].plot(t, sig, color=GREEN, linewidth=1.0, label="sigma")
    axes[1].legend(fontsize=8)
    setup_axis(axes[1], xlabel="time", ylabel="accel", title="thrust")
    fig.tight_layout()
    _save(fig, prefix, "quadrotor_inputs")
    return fig1, fig


def plot_freeflyer(sol, rooms: Sequence = (), obstacles: Sequence = (), *,
                   prefix: Optional[str] = None):
    """XY track through the station rooms + quaternion norm sanity + a 3D
    scene render of the flight path (reference freeflyer/plots.jl uses the
    scene_3d ISS render; here utils/scene3d draws the room boxes and
    trajectory polyline)."""
    plt = _plt()
    fig1 = plot_trajectory_2d(sol, axes=(0, 1), prisms=rooms,
                              obstacles=obstacles, name="freeflyer xy")
    _save(fig1, prefix, "freeflyer_traj")

    t = as_numpy(sol.t_grid)
    q = as_numpy(sol.xd)[:, 6:10]
    fig, ax = plt.subplots(figsize=(5, 3))
    ax.plot(t, np.linalg.norm(q, axis=1) - 1.0, color=BLUE)
    setup_axis(ax, xlabel="time", ylabel="||q|| - 1",
               title="quaternion norm drift")
    fig.tight_layout()
    _save(fig, prefix, "freeflyer_qnorm")

    # 3D scene: room boxes + trajectory polyline + start/goal markers
    from scptoolbox_torch.utils import scene3d as s3

    scene = s3.Scene3D()
    r = as_numpy(sol.xd)[:, :3]
    center = r.mean(axis=0)
    span = float(np.max(np.ptp(r, axis=0))) + 1.0
    cam = scene.add(s3.Camera3D(name="cam", fovy=45.0, znear=0.1,
                                zfar=100.0 + 10 * span))
    cam.look_at(center + np.asarray([1.6, 1.2, 0.9]) * span, center)
    scene.add(s3.Light3D(az=300.0, el=55.0))
    for room in rooms:
        lo = as_numpy(room.l)[:3]
        hi = as_numpy(room.u)[:3]
        scene.add(s3.box(tuple(hi - lo), center=tuple((hi + lo) / 2),
                         face_color="lightsteelblue", edge_color="gray",
                         edge_width=0.2))
    scene.add(s3.polyline(r, edge_color=RED, edge_width=1.5))
    scene.add(s3.sphere(0.05 * span, center=r[0], face_color=GREEN))
    scene.add(s3.sphere(0.05 * span, center=r[-1], face_color=RED))
    fig3, _ = scene.render("cam", f"{prefix}_freeflyer_3d.png"
                           if prefix else None)
    return fig1, fig, fig3


def plot_starship(sol, *, prefix: Optional[str] = None):
    """Flip trajectory with attitude glyphs along the path, thrust and
    gimbal traces (reference starship_flip/plots.jl draws the vehicle
    outline at nodes; here an axis glyph per node shows the attitude)."""
    plt = _plt()
    xd = as_numpy(sol.xd)
    ud = as_numpy(sol.ud)
    t = as_numpy(sol.t_grid)
    # states: r (x, z), v, theta, omega, m, delta_dot (models ID_*)
    fig, ax = plt.subplots(figsize=(5.5, 6))
    ax.plot(xd[:, 0], xd[:, 1], color=DARK, linewidth=1.2)
    L = 0.06 * float(np.max(np.ptp(xd[:, :2], axis=0)) + 1e-9)
    for k in range(xd.shape[0]):
        th = xd[:, 4][k]
        d = np.asarray([math.sin(th), math.cos(th)])  # body +z in plane
        ax.plot([xd[k, 0] - L * d[0], xd[k, 0] + L * d[0]],
                [xd[k, 1] - L * d[1], xd[k, 1] + L * d[1]],
                color=RED, linewidth=1.6, alpha=0.8)
    setup_axis(ax, xlabel="downrange", ylabel="altitude",
               title="starship flip (attitude glyphs)", axis_equal=True)
    fig.tight_layout()
    _save(fig, prefix, "starship_traj")

    fig2 = _input_timeseries(
        t, ud[:, :2], ["thrust T", "gimbal delta"],
        title="starship inputs")
    _save(fig2, prefix, "starship_inputs")
    return fig, fig2


def plot_rendezvous(sol, *, n_thrusters: Optional[int] = None,
                    prefix: Optional[str] = None,
                    name: str = "rendezvous"):
    """Impulse stem trains per thruster + approach trace (reference
    rendezvous_planar/plots.jl and rendezvous_3d/plots.jl pulse plots)."""
    plt = _plt()
    xd = as_numpy(sol.xd)
    ud = as_numpy(sol.ud)
    t = as_numpy(sol.t_grid)
    nu = ud.shape[1] if n_thrusters is None else n_thrusters

    fig, ax = plt.subplots(figsize=(5, 4.5))
    ax.plot(xd[:, 0], xd[:, 1], "-o", color=BLUE, markersize=3)
    ax.plot([0], [0], "s", color=RED, markersize=6, label="target")
    ax.legend(fontsize=8)
    setup_axis(ax, xlabel="x", ylabel="y", title=f"{name} approach",
               axis_equal=True)
    fig.tight_layout()
    _save(fig, prefix, f"{name}_approach")

    ncol = 3
    nrow = int(np.ceil(nu / ncol))
    fig2, axes = plt.subplots(nrow, ncol, figsize=(3 * ncol, 1.6 * nrow),
                              squeeze=False, sharex=True)
    for i in range(nu):
        ax = axes[i // ncol][i % ncol]
        ax.stem(t, ud[:, i], basefmt=" ",
                linefmt=f"C0-", markerfmt="C0.")
        setup_axis(ax, ylabel=f"f{i}", grid=False)
    for i in range(nu, nrow * ncol):
        axes[i // ncol][i % ncol].axis("off")
    fig2.suptitle(f"{name} thruster impulses", fontsize=10)
    fig2.tight_layout()
    _save(fig2, prefix, f"{name}_impulses")
    return fig, fig2
