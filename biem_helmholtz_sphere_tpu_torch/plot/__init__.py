"""Visualization (reference layer 5, plot.py — plotly there, matplotlib here).

The port of biem_helmholtz_sphere_tpu.plot: the fields are evaluated on
the calculator's device and drawn from numpy copies.

`plot_biem`: near-field heatmap on an axis-aligned plane (u_in + selected
per-ball u_scat), real part with e^{-2 pi i t} time phase, optional
signed-log scale (reference: plot.py:12-130).
`plot_biem_far`: polar far-field |u_inf| on the unit circle of a chosen
coordinate plane (reference: plot.py:133-217).
"""

import numpy as np


def to_numpy(t):
    """A numpy copy of a tensor on any device."""
    return t.detach().cpu().numpy()


__all__ = ["animate_biem", "plot_biem", "plot_biem_far", "signed_log"]


def signed_log(x):
    """sign(x) * log10(1 + |x|) — the reference's signed-log scale."""
    return np.sign(x) * np.log10(1.0 + np.abs(x))


def _plane_grid(d, axes, lim, n_points):
    g = np.linspace(-lim, lim, n_points)
    xx, yy = np.meshgrid(g, g)
    pts = np.zeros((d, n_points * n_points))
    pts[axes[0]] = xx.ravel()
    pts[axes[1]] = yy.ravel()
    return g, pts


def plot_biem(
    biem_res,
    t=0.0,
    axes=(0, 1),
    lim=6.0,
    n_points=128,
    balls=None,
    use_signed_log=False,
    include_uin=True,
    ax=None,
):
    """Near-field heatmap of Re[(u_in + u_scat) e^{-2 pi i t}] on a plane.

    axes: which two cartesian axes span the plane (others fixed at 0).
    balls: optional list of ball indices whose scattered field to include
    (reference's per-ball selection; default all).
    Returns the matplotlib Axes.
    """
    import matplotlib.pyplot as plt

    c = biem_res.c
    d = c.c_ndim
    g, pts = _plane_grid(d, axes, lim, n_points)
    x = pts
    us = to_numpy(biem_res.uscat(x, per_ball=True))
    # [..., first(broadcast scalars), B]; collapse possible first dims
    us = us.reshape(pts.shape[1], -1, us.shape[-1])[:, 0, :]
    if balls is not None:
        us = us[:, list(balls)]
    u = us.sum(axis=-1)
    if include_uin and biem_res.uin is not None:
        u = u + to_numpy(biem_res.uin(x)).reshape(pts.shape[1], -1)[:, 0]
    field = np.real(u * np.exp(-2j * np.pi * t)).reshape(n_points, n_points)
    if use_signed_log:
        field = signed_log(field)
    if ax is None:
        _, ax = plt.subplots(figsize=(5, 4.4))
    vmax = np.nanmax(np.abs(field))
    im = ax.imshow(
        field,
        origin="lower",
        extent=(-lim, lim, -lim, lim),
        cmap="RdBu_r",
        vmin=-vmax,
        vmax=vmax,
    )
    ax.set_xlabel(f"x{axes[0]}")
    ax.set_ylabel(f"x{axes[1]}")
    ax.figure.colorbar(im, ax=ax, shrink=0.85)
    ax.set_title("Re u(x)" + (" [signed log]" if use_signed_log else ""))
    return ax


def animate_biem(
    biem_res,
    path,
    n_frames=20,
    fps=10,
    axes=(0, 1),
    lim=6.0,
    n_points=128,
    balls=None,
    use_signed_log=False,
    include_uin=True,
):
    """Time animation Re[u e^{-2 pi i t}], t in [0, 1) — the reference's
    plot_biem animation frames (plot.py:96-118) written to a GIF.

    The field is evaluated ONCE; frames only re-apply the time phase.
    Returns the output path.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, PillowWriter

    c = biem_res.c
    d = c.c_ndim
    g, pts = _plane_grid(d, axes, lim, n_points)
    x = pts
    us = to_numpy(biem_res.uscat(x, per_ball=True))
    us = us.reshape(pts.shape[1], -1, us.shape[-1])[:, 0, :]
    if balls is not None:
        us = us[:, list(balls)]
    u = us.sum(axis=-1)
    if include_uin and biem_res.uin is not None:
        u = u + to_numpy(biem_res.uin(x)).reshape(pts.shape[1], -1)[:, 0]
    u = u.reshape(n_points, n_points)
    vmax = np.nanmax(np.abs(u))

    fig, ax = plt.subplots(figsize=(5, 4.4))
    frame0 = np.real(u)
    if use_signed_log:
        frame0, vmax = signed_log(frame0), signed_log(vmax)
    im = ax.imshow(
        frame0,
        origin="lower",
        extent=(-lim, lim, -lim, lim),
        cmap="RdBu_r",
        vmin=-vmax,
        vmax=vmax,
    )
    ax.set_xlabel(f"x{axes[0]}")
    ax.set_ylabel(f"x{axes[1]}")
    fig.colorbar(im, ax=ax, shrink=0.85)

    def update(i):
        f = np.real(u * np.exp(-2j * np.pi * i / n_frames))
        if use_signed_log:
            f = signed_log(f)
        im.set_data(f)
        ax.set_title(f"Re u(x) e^{{-2π i t}},  t = {i / n_frames:.2f}")
        return (im,)

    anim = FuncAnimation(fig, update, frames=n_frames, blit=False)
    anim.save(path, writer=PillowWriter(fps=fps))
    plt.close(fig)
    return path


def plot_biem_far(biem_res, axes=(0, 1), n_points=360, per_ball=True, ax=None):
    """Polar plot of |u_inf| over unit directions in a coordinate plane."""
    import matplotlib.pyplot as plt

    c = biem_res.c
    d = c.c_ndim
    phi = np.linspace(0.0, 2 * np.pi, n_points, endpoint=False)
    pts = np.zeros((d, n_points))
    pts[axes[0]] = np.cos(phi)
    pts[axes[1]] = np.sin(phi)
    uinf = to_numpy(biem_res.uscat(pts, far_field=True, per_ball=per_ball))
    uinf = uinf.reshape(n_points, -1, uinf.shape[-1] if per_ball else 1)[:, 0, :]
    if ax is None:
        _, ax = plt.subplots(subplot_kw={"projection": "polar"}, figsize=(4.6, 4.4))
    if per_ball:
        for b in range(uinf.shape[-1]):
            ax.plot(phi, np.abs(uinf[:, b]), lw=1, label=f"ball {b}")
        ax.plot(phi, np.abs(uinf.sum(axis=-1)), "k-", lw=1.8, label="total")
        if uinf.shape[-1] <= 6:
            ax.legend(fontsize=7, loc="lower left")
    else:
        ax.plot(phi, np.abs(uinf[:, 0]), "k-", lw=1.8)
    ax.set_title(r"$|u_\infty(\hat x)|$", fontsize=10)
    return ax
