"""Offline visualization (the rviz topic suite, rendered to files).

The reference publishes 16 rviz topics (C17: odometry, paths, point clouds,
key poses, camera-frustum markers, loop edges — visualization.cpp:25-39,
CameraPoseVisualization). Headless accelerator hosts have no rviz; this module renders
the same artifacts to PNG with matplotlib (Agg):

  * plot_trajectories: N named trajectories, top-down + altitude profile
  * plot_map: LiDAR map points colored by height + trajectory overlay
  * plot_loops: trajectory with loop-closure chords
  * plot_frusta: camera poses as frustum wireframes (3D)
"""
from __future__ import annotations

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def plot_trajectories(named_trajs: dict, path: str, title: str = "trajectories"):
    """named_trajs: {label: (N, 3) positions}."""
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 5))
    for label, ps in named_trajs.items():
        ps = np.asarray(ps)
        ax1.plot(ps[:, 0], ps[:, 1], label=label, linewidth=1.2)
        ax2.plot(ps[:, 2], label=label, linewidth=1.0)
    ax1.set_aspect("equal")
    ax1.set_xlabel("x [m]")
    ax1.set_ylabel("y [m]")
    ax1.legend()
    ax1.set_title(title)
    ax2.set_xlabel("frame")
    ax2.set_ylabel("z [m]")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_map(map_pts, map_valid, traj_ps, path: str, title: str = "map"):
    pts = np.asarray(map_pts)[np.asarray(map_valid)]
    fig, ax = plt.subplots(figsize=(9, 8))
    if len(pts):
        ax.scatter(pts[:, 0], pts[:, 1], c=pts[:, 2], s=0.5, cmap="viridis",
                   alpha=0.6, linewidths=0)
    traj_ps = np.asarray(traj_ps)
    if len(traj_ps):
        ax.plot(traj_ps[:, 0], traj_ps[:, 1], "r-", linewidth=1.5, label="trajectory")
        ax.legend()
    ax.set_aspect("equal")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_loops(traj_ps, loop_pairs, path: str, title: str = "loop closures"):
    """loop_pairs: [(i, j), ...] indices into traj_ps."""
    ps = np.asarray(traj_ps)
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.plot(ps[:, 0], ps[:, 1], "b-", linewidth=1.0)
    for i, j in loop_pairs:
        ax.plot([ps[i, 0], ps[j, 0]], [ps[i, 1], ps[j, 1]], "g-", linewidth=0.8)
        ax.plot(ps[[i, j], 0], ps[[i, j], 1], "go", markersize=3)
    ax.set_aspect("equal")
    ax.set_title(f"{title} ({len(loop_pairs)} loops)")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def _frustum_lines(R_wc, p_wc, scale=0.6, aspect=0.75):
    """Camera frustum wireframe segments (CameraPoseVisualization analog)."""
    w = scale
    h = scale * aspect
    d = scale * 1.2
    corners = np.array([[-w, -h, d], [w, -h, d], [w, h, d], [-w, h, d]])
    cw = corners @ R_wc.T + p_wc
    segs = []
    for k in range(4):
        segs.append((p_wc, cw[k]))
        segs.append((cw[k], cw[(k + 1) % 4]))
    return segs


def plot_frusta(Rs_wc, ps_wc, path: str, title: str = "camera poses"):
    fig = plt.figure(figsize=(9, 8))
    ax = fig.add_subplot(111, projection="3d")
    ps = np.asarray(ps_wc)
    ax.plot(ps[:, 0], ps[:, 1], ps[:, 2], "b-", linewidth=0.8)
    for R, p in zip(np.asarray(Rs_wc), ps):
        for a, b in _frustum_lines(R, p):
            ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]], "r-", linewidth=0.5)
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def render_pipeline_report(pipeline, out_dir: str):
    """One-call dump of every visualization the pipeline can produce."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    o = pipeline.outputs
    ini = o.initialized or [True] * len(o.ts)
    sel = [k for k, ok in enumerate(ini) if ok]
    trajs = {"vio": [o.vio_p[k] for k in sel]}
    if o.loop_p:
        trajs["loop-corrected"] = [o.loop_p[k] for k in sel]
    if o.lidar_p:
        trajs["lidar-odom"] = o.lidar_p
    if trajs["vio"]:
        plot_trajectories(trajs, os.path.join(out_dir, "trajectories.png"))
    ls = pipeline.lidar_state
    if int(np.asarray(ls.surf_map_valid).sum()):
        plot_map(ls.surf_map, ls.surf_map_valid, o.lidar_p,
                 os.path.join(out_dir, "map.png"))
    if pipeline.fusion is not None and pipeline.fusion.n_kf:
        _, p_all = pipeline.fusion.poses()
        plot_loops(p_all, pipeline.fusion.loops_found,
                   os.path.join(out_dir, "loops.png"))
