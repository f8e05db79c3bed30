"""Headless visualization artifacts.

Port of `allocnet_tpu/viz/artifacts.py` on the port's Trajectory and
flatness map; matplotlib is imported inside the plotting functions (it is
an optional dependency), SciPy inside `polytope_mesh`.  The original
module: replaces the reference's RViz marker pipeline (visualizer.hpp:48-371) and the
matplotlib/plotly helpers (min_traj_opt.py:763-841): trajectory state plots,
corridor meshes, and flatness telemetry, written to files.  Vertex
enumeration for corridor meshes uses scipy HalfspaceIntersection + ConvexHull
on host (the reference's sdlp+quickhull enumerateVs path, geo_utils.hpp:155,
quickhull.hpp — host-side viz work, not TPU-critical per SURVEY.md 2.1.5).
"""

from __future__ import annotations

import numpy as np
import torch

from allocnet_tpu_torch.config import PhysParams
from allocnet_tpu_torch.planner import flatness, trajectory


def polytope_mesh(hpoly: np.ndarray):
    """(F, 4) a.x <= b rows -> (vertices, simplices) or None if degenerate."""
    import scipy.spatial as sps
    from scipy.optimize import linprog

    A, b = hpoly[:, :3], hpoly[:, 3]
    # interior point via LP (geo_utils::findInterior analog on host)
    norms = np.linalg.norm(A, axis=1)
    res = linprog(c=[0, 0, 0, -1],
                  A_ub=np.hstack([A, norms[:, None]]), b_ub=b,
                  bounds=[(None, None)] * 3 + [(0, None)])
    if not res.success or res.x[3] <= 1e-9:
        return None
    interior = res.x[:3]
    try:
        hs = sps.HalfspaceIntersection(
            np.hstack([A, -b[:, None]]), interior)
        pts = hs.intersections
        hull = sps.ConvexHull(pts)
        return pts, hull.simplices
    except Exception:
        return None


def plot_trajectory(traj: trajectory.Trajectory, index: int, path: str,
                    phys: PhysParams | None = None, samples: int = 200):
    """Position/velocity/acceleration traces (+ flatness telemetry when phys
    is given: speed, thrust, tilt, body-rate — the reference's Float64 topics,
    visualizer.hpp:57-60)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with torch.no_grad():
        t, states = trajectory.sample(traj, samples, max_deriv=3)
    t = t[index].cpu().numpy()
    st = states[index].cpu().numpy()        # (n, 4, 3)

    rows = 3 if phys is None else 5
    fig, axes = plt.subplots(rows, 1, figsize=(8, 2.2 * rows), sharex=True)
    labels = ["pos [m]", "vel [m/s]", "acc [m/s^2]"]
    for r in range(3):
        for j, axname in enumerate("xyz"):
            axes[r].plot(t, st[:, r, j], label=axname)
        axes[r].set_ylabel(labels[r])
        axes[r].legend(loc="upper right", fontsize=7)

    if phys is not None:
        T = lambda a: torch.as_tensor(a)
        out = flatness.forward(
            phys, T(st[:, 1]), T(st[:, 2]), T(st[:, 3]),
            torch.zeros(len(t), dtype=T(st).dtype),
            torch.zeros(len(t), dtype=T(st).dtype))
        speed = np.linalg.norm(st[:, 1], axis=1)
        quat = out.quat.numpy()
        tilt = np.degrees(np.arccos(np.clip(
            1.0 - 2.0 * (quat[:, 1] ** 2 + quat[:, 2] ** 2), -1, 1)))
        axes[3].plot(t, speed, label="speed")
        axes[3].plot(t, out.thrust.numpy(), label="thrust")
        axes[3].set_ylabel("speed / thrust")
        axes[3].legend(fontsize=7)
        axes[4].plot(t, tilt, label="tilt [deg]")
        axes[4].plot(t, np.linalg.norm(out.omega.numpy(), axis=1),
                     label="|body rate|")
        axes[4].set_ylabel("attitude")
        axes[4].legend(fontsize=7)

    axes[-1].set_xlabel("t [s]")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_corridor_3d(hpolys: list[np.ndarray], traj_pts: np.ndarray | None,
                     route: np.ndarray | None, path: str):
    """3D corridor mesh + trajectory + route (the RViz visualizePolytope /
    visualize equivalents, visualizer.hpp:71-266)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    fig = plt.figure(figsize=(8, 7))
    ax = fig.add_subplot(projection="3d")
    for hp in hpolys:
        mesh = polytope_mesh(hp)
        if mesh is None:
            continue
        pts, simplices = mesh
        tri = [pts[s] for s in simplices]
        ax.add_collection3d(Poly3DCollection(
            tri, alpha=0.12, facecolor="orange", edgecolor="gray",
            linewidths=0.3))
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=1, c="gray")
    if route is not None and len(route):
        ax.plot(route[:, 0], route[:, 1], route[:, 2], "b--", lw=1,
                label="route")
    if traj_pts is not None and len(traj_pts):
        ax.plot(traj_pts[:, 0], traj_pts[:, 1], traj_pts[:, 2], "r-", lw=2,
                label="trajectory")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
