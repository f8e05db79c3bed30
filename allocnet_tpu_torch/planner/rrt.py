"""Host-side RRT path finder (NumPy + scipy KDTree).

A copy of `allocnet_tpu/planner/rrt.py`: tree search is pointer chasing
and stays on the host.  The C++ runtime (planner/native.py) has the same
interface and Informed RRT*; this is the Python front end that
`planner.build_map(native=False)` selects.

Defaults mirror rrt3D.py: maxiter 5000, stepsize 1.0, goal bias 0.1,
KDTree clearance collision checks.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import KDTree


def plan(
    start: np.ndarray,
    goal: np.ndarray,
    obstacle_points: np.ndarray,   # (N, 3)
    bounds_lo: np.ndarray,
    bounds_hi: np.ndarray,
    safe_dis: float = 0.5,
    step: float = 1.0,
    max_iter: int = 5000,
    goal_bias: float = 0.1,
    seed: int = 0,
) -> np.ndarray | None:
    """Returns waypoints (K, 3) from start to goal, or None."""
    rng = np.random.default_rng(seed)
    start = np.asarray(start, float)
    goal = np.asarray(goal, float)
    tree = KDTree(obstacle_points) if len(obstacle_points) else None

    def blocked(p) -> bool:
        if np.any(p < bounds_lo) or np.any(p > bounds_hi):
            return True
        if tree is None:
            return False
        return tree.query(p)[0] < safe_dis

    def edge_blocked(a, b) -> bool:
        d = np.linalg.norm(b - a)
        n = max(2, int(d / (0.5 * safe_dis)) + 1)
        for t in np.linspace(0.0, 1.0, n):
            if blocked(a + t * (b - a)):
                return True
        return False

    if blocked(start) or blocked(goal):
        return None

    parents = [-1]
    arr = np.zeros((max_iter + 1, 3))
    arr[0] = start
    count = 1

    for _ in range(max_iter):
        if rng.random() < goal_bias:
            sample = goal
        else:
            sample = rng.uniform(bounds_lo, bounds_hi)
            if blocked(sample):
                continue
        near = int(np.argmin(np.linalg.norm(arr[:count] - sample, axis=1)))
        direction = sample - arr[near]
        dist = np.linalg.norm(direction)
        if dist < 1e-9:
            continue
        new = arr[near] + direction / dist * min(step, dist)
        if edge_blocked(arr[near], new):
            continue
        arr[count] = new
        parents.append(near)
        count += 1
        if np.linalg.norm(new - goal) <= step and not edge_blocked(new, goal):
            # backtrack
            path = [goal]
            i = count - 1
            while i >= 0:
                path.append(arr[i].copy())
                i = parents[i]
            return np.asarray(path[::-1])
    return None


def simplify(path: np.ndarray, obstacle_points: np.ndarray,
             safe_dis: float = 0.5) -> np.ndarray:
    """Greedy shortcut: drop intermediate waypoints whose bypassing edge
    stays clear (OMPL's path simplification analog)."""
    if path is None or len(path) <= 2:
        return path
    tree = KDTree(obstacle_points) if len(obstacle_points) else None

    def edge_clear(a, b):
        if tree is None:
            return True
        d = np.linalg.norm(b - a)
        n = max(2, int(d / (0.5 * safe_dis)) + 1)
        pts = a[None, :] + np.linspace(0, 1, n)[:, None] * (b - a)[None, :]
        return np.min(tree.query(pts)[0]) >= safe_dis

    out = [path[0]]
    i = 0
    while i < len(path) - 1:
        j = len(path) - 1
        while j > i + 1 and not edge_clear(path[i], path[j]):
            j -= 1
        out.append(path[j])
        i = j
    return np.asarray(out)
