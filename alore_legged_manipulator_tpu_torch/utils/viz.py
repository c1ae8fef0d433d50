"""Static visualization: the RViz/visualizer.hpp analogue (port of
utils/viz.py).  Host only: every input may be a numpy array or a tensor
on any device (it comes to the host once), and matplotlib is imported
inside the functions that draw, so importing this module needs none.

The reference ships a marker-heavy RViz layer -- car mesh + trajectory
lines from the simulator (simulator.h:362-470), planner path/ESDF
markers (plan_manager visualizer.hpp, mincoPathPub optimizer.cpp:1593),
and wall-time text markers.  Without ROS, the equivalent deliverable is
publication-quality matplotlib figures: map + ESDF field, planned vs
executed trajectories, mission overviews, and tracking diagnostics.

Conventions (dataviz method): categorical hues in fixed slot order from
a CVD-validated palette; the ESDF magnitude field is a single-hue
sequential ramp; marks are thin (2 px lines, small markers); grid/axes
recessive; text in neutral ink, never series colors; status red is
reserved for violations/collisions.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

# validated categorical palette (fixed slot order; dataviz reference set)
SERIES = ["#2a78d6",   # 1 blue    -- planned / primary trajectory
          "#eb6834",   # 2 orange  -- executed / measured
          "#1baf7a",   # 3 aqua    -- front-end (JPS) path
          "#eda100",   # 4 yellow
          "#e87ba4",   # 5 magenta
          "#008300"]   # 6 green
STATUS_BAD = "#e34948"    # reserved: collisions / violations
INK = "#0b0b0b"
INK_MUTED = "#52514e"
SURFACE = "#fcfcfb"
OBSTACLE = "#3a3935"


def _arr(x, dtype=None):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def _ax_style(ax, title=None):
    ax.set_facecolor(SURFACE)
    ax.grid(True, color="#e4e3df", linewidth=0.6)
    ax.set_axisbelow(True)
    for s in ax.spines.values():
        s.set_color("#d4d3cd")
    ax.tick_params(colors=INK_MUTED, labelsize=8)
    if title:
        ax.set_title(title, color=INK, fontsize=10)


def plot_map(ax, occ, lower, res, esdf_dist: Optional[np.ndarray] = None,
             title: Optional[str] = None):
    """Occupancy grid (+ optional ESDF distance field as a sequential
    single-hue ramp underneath).  occ is (H, W) indexed [ix, iy] with x
    along axis 0 (the SDFmap layout)."""
    occ = _arr(occ, bool)
    ext = [lower[0], lower[0] + occ.shape[0] * res,
           lower[1], lower[1] + occ.shape[1] * res]
    _ax_style(ax, title)
    if esdf_dist is not None:
        d = _arr(esdf_dist, float)
        ax.imshow(d.T, origin="lower", extent=ext, cmap="Blues_r",
                  alpha=0.55, interpolation="bilinear")
    from matplotlib.colors import ListedColormap

    show = np.ma.masked_where(~occ.T, np.ones_like(occ.T, float))
    ax.imshow(show, origin="lower", extent=ext,
              cmap=ListedColormap([OBSTACLE]), interpolation="nearest")
    ax.set_xlim(ext[0], ext[1])
    ax.set_ylim(ext[2], ext[3])
    ax.set_aspect("equal")


def plot_path(ax, xy, slot: int = 0, label: Optional[str] = None,
              dashed: bool = False):
    """A 2 px trajectory/path line in a fixed categorical slot."""
    xy = _arr(xy, float)
    ax.plot(xy[:, 0], xy[:, 1], color=SERIES[slot % len(SERIES)],
            linewidth=2.0, linestyle="--" if dashed else "-", label=label)


def plot_poses(ax, poses, slot: int = 0, label: Optional[str] = None,
               every: int = 1, arrow_len: float = 0.25):
    """Pose markers with heading arrows (the rviz car-pose markers)."""
    poses = _arr(poses, float)[::every]
    c = SERIES[slot % len(SERIES)]
    ax.plot(poses[:, 0], poses[:, 1], ".", color=c, markersize=4,
            label=label)
    ax.quiver(poses[:, 0], poses[:, 1],
              arrow_len * np.cos(poses[:, 2]),
              arrow_len * np.sin(poses[:, 2]),
              color=c, width=0.004, scale=1.0, scale_units="xy",
              angles="xy")


def plot_markers(ax, pts, kind: str = "item", labels=None):
    """Item/target markers with text labels (identity never color-alone)."""
    pts = _arr(pts, float).reshape(-1, 2)
    style = {"item": dict(marker="s", color=SERIES[4]),
             "target": dict(marker="*", color=SERIES[3]),
             "goal": dict(marker="*", color=SERIES[1]),
             "start": dict(marker="o", color=SERIES[0])}[kind]
    ax.scatter(pts[:, 0], pts[:, 1], s=90, zorder=5,
               edgecolors=SURFACE, linewidths=1.0, **style)
    for i, p in enumerate(pts):
        txt = labels[i] if labels else f"{kind}{i}"
        ax.annotate(txt, p, textcoords="offset points", xytext=(6, 6),
                    fontsize=8, color=INK)


def tracking_figure(result, tt=None, occ=None, lower=(0.0, 0.0),
                    res: float = 0.1, esdf_dist=None, dt: float = 0.01):
    """Closed-loop tracking diagnostic: XY overview + error traces.

    result: one lane of runtime.closed_loop.TrackingResult (the port's
    is batched: `TrackingResult(*(x[b] for x in res))`), or anything
    with .xytheta (T,3), .pos_err (T,), .icr_err (T,); tt: anything with
    one lane's .seq (K+1, 3).  Returns the figure.
    """
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(13, 4.2), facecolor=SURFACE)
    ax = axes[0]
    if occ is not None:
        plot_map(ax, occ, lower, res, esdf_dist, title="closed-loop XY")
    else:
        _ax_style(ax, "closed-loop XY")
        ax.set_aspect("equal")
    if tt is not None:
        seq = _arr(tt.seq, float)
        plot_path(ax, seq[:, :2], slot=0, label="planned", dashed=True)
    xs = _arr(result.xytheta, float)
    plot_path(ax, xs[:, :2], slot=1, label="executed")
    ax.legend(loc="best", fontsize=8, framealpha=0.9)

    t = np.arange(len(xs)) * dt
    ax = axes[1]
    _ax_style(ax, "tracking error")
    ax.plot(t, _arr(result.pos_err, float), color=SERIES[1],
            linewidth=2.0)
    ax.set_xlabel("t [s]", color=INK_MUTED, fontsize=8)
    ax.set_ylabel("m", color=INK_MUTED, fontsize=8)

    ax = axes[2]
    _ax_style(ax, "EKF ICR parameter error")
    ax.plot(t, _arr(result.icr_err, float), color=SERIES[0],
            linewidth=2.0)
    ax.set_xlabel("t [s]", color=INK_MUTED, fontsize=8)
    ax.set_ylabel("|ICR err|", color=INK_MUTED, fontsize=8)
    fig.tight_layout()
    return fig


def mission_figure(occ, lower, res, items, targets,
                   object_tracks: Optional[Sequence] = None,
                   robot_track=None, title: str = "arrangement mission"):
    """Mission overview: map, items, targets, executed object tracks."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6.4, 6.0), facecolor=SURFACE)
    plot_map(ax, occ, lower, res, title=title)
    if robot_track is not None:
        plot_path(ax, _arr(robot_track)[:, :2], slot=0,
                  label="robot")
    if object_tracks:
        for i, trk in enumerate(object_tracks):
            plot_path(ax, _arr(trk)[:, :2], slot=(i + 1) % 6,
                      label=f"object {i}")
    plot_markers(ax, _arr(items, float)[:, :2], "item")
    plot_markers(ax, _arr(targets, float)[:, :2], "target")
    ax.legend(loc="best", fontsize=8, framealpha=0.9)
    fig.tight_layout()
    return fig


def save_figure(fig, path: str, dpi: int = 150):
    fig.savefig(path, dpi=dpi, facecolor=fig.get_facecolor(),
                bbox_inches="tight")
    return path
