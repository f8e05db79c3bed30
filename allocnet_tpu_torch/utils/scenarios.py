"""Synthetic scenario generation (host-side NumPy), a copy of
`allocnet_tpu/utils/scenarios.py` that draws the same arrays per seed.

Produces batches of (state, hpolys, times, seg) in the exact padded tensor
layout the reference feeds its network/QP (learning_planner.hpp:147-168,
datasets.py:25-42): states as start/end PVA, corridors as zero-padded
(S, F, 4) half-space stacks with unit normals and a.x <= b orientation
(the post-normalization convention of learning_planner.hpp:293-299).

Corridors are built as overlapping axis-aligned boxes around a jittered
waypoint path, with optional extra slanted faces — geometrically equivalent
to what the FIRI/IRIS pipeline emits, but cheap and deterministic for tests
and benchmarks.  Times use the reference's lower-bound heuristic
(min_traj_opt.py:195-210: max(dist/vmax, sqrt(2*dist/amax)) per segment).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from allocnet_tpu_torch.config import QPConfig


class ScenarioBatch(NamedTuple):
    state: np.ndarray    # (B, 2, 3, 3) [start/end, axis, (p,v,a)]
    hpolys: np.ndarray   # (B, S, F, 4)
    times: np.ndarray    # (B, S)
    seg: np.ndarray      # (B,) int32


def _box_faces(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """6 half-space rows a.x <= b for the box [lo, hi], unit normals."""
    rows = []
    for j in range(3):
        a = np.zeros(3); a[j] = 1.0
        rows.append(np.concatenate([a, [hi[j]]]))
        rows.append(np.concatenate([-a, [-lo[j]]]))
    return np.asarray(rows)


def _slant_faces(center: np.ndarray, radius: float, k: int, rng) -> np.ndarray:
    """k extra slanted faces tangent to a sphere of `radius` around center
    (always redundant w.r.t. an inscribed region, keeps the polytope valid)."""
    dirs = rng.normal(size=(k, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    b = dirs @ center + radius
    return np.concatenate([dirs, b[:, None]], axis=1)


def time_lower_bounds(waypts: np.ndarray, vmax: float, amax: float) -> np.ndarray:
    """Per-segment time lower bound; reference min_traj_opt.py:195-210."""
    d = waypts[1:] - waypts[:-1]
    vel_t = np.abs(d / vmax)
    acc_t = np.abs(2.0 * d / amax)
    return np.maximum(vel_t.max(axis=1), np.sqrt(acc_t.max(axis=1)))


def quintic_time_bounds(waypts: np.ndarray, vmax: float, amax: float) -> np.ndarray:
    """Feasibility-aware per-segment bound: a rest-to-rest quintic over
    distance d peaks at 1.875 d/T velocity and 5.774 d/T^2 acceleration, so
    the reference's trapezoid heuristic (factor 2 d/a) under-budgets time by
    ~2.9x and yields infeasible QPs.  Used by the synthetic generator to keep
    scenarios solvable."""
    d = np.abs(waypts[1:] - waypts[:-1])
    return np.maximum((1.875 * d / vmax).max(axis=1),
                      np.sqrt(5.774 * d / amax).max(axis=1))


def corridor_time_lower_bounds(hpolys: np.ndarray, state: np.ndarray,
                               seg: np.ndarray, vmax: float,
                               amax: float) -> np.ndarray:
    """Per-segment time lower bounds for use_time_factor mode, from the
    corridor's junction waypoints (the reference's getT_lbs over
    get_inner_pts, min_traj_opt.py:195-276).  Host-side: the junction
    interiors come from ops/lp.find_interior in float64 on the CPU.

    Returns (B, S) with zeros on padded segments."""
    import torch

    from allocnet_tpu_torch.ops import lp

    B, S = hpolys.shape[:2]
    out = np.zeros((B, S))
    for b in range(B):
        L = int(seg[b])
        waypts = [state[b, 0, :, 0]]
        if L > 1:
            inter = np.zeros((L - 1, 2 * hpolys.shape[2], 4))
            for i in range(L - 1):
                inter[i] = np.concatenate([hpolys[b, i], hpolys[b, i + 1]])
            mask = np.linalg.norm(inter[:, :, :3], axis=2) > 1e-6
            pt, _ = lp.find_interior(torch.as_tensor(inter, dtype=torch.float64),
                                     torch.as_tensor(mask, dtype=torch.float64))
            waypts.extend(pt.numpy())
        waypts.append(state[b, 1, :, 0])
        out[b, :L] = time_lower_bounds(np.asarray(waypts), vmax, amax)
    return out


def random_scenarios(
    cfg: QPConfig,
    batch: int,
    seed: int = 0,
    min_seg: int = 2,
    max_seg: int | None = None,
    rest_to_rest: bool = True,
    time_slack: float = 2.0,
    extra_faces: int = 4,
) -> ScenarioBatch:
    rng = np.random.default_rng(seed)
    S, F = cfg.max_seg, cfg.max_faces
    max_seg = max_seg or S

    state = np.zeros((batch, 2, 3, 3))
    hpolys = np.zeros((batch, S, F, 4))
    times = np.zeros((batch, S))
    segs = np.zeros((batch,), np.int32)

    for b in range(batch):
        L = int(rng.integers(min_seg, max_seg + 1))
        segs[b] = L

        # jittered waypoint path
        direction = rng.normal(size=3)
        direction[2] *= 0.3
        direction /= np.linalg.norm(direction)
        step = rng.uniform(1.5, 3.0)
        waypts = np.cumsum(
            np.concatenate([np.zeros((1, 3)),
                            direction[None, :] * step
                            + rng.normal(scale=0.4, size=(L, 3))]), axis=0)
        waypts += rng.uniform(-5, 5, size=3)

        # overlapping boxes, one per segment
        margin = rng.uniform(0.8, 1.4)
        for i in range(L):
            lo = np.minimum(waypts[i], waypts[i + 1]) - margin
            hi = np.maximum(waypts[i], waypts[i + 1]) + margin
            faces = _box_faces(lo, hi)
            k = int(rng.integers(0, extra_faces + 1))
            if k:
                center = 0.5 * (waypts[i] + waypts[i + 1])
                radius = 0.6 * np.linalg.norm(hi - lo)
                faces = np.concatenate([faces, _slant_faces(center, radius, k, rng)])
            hpolys[b, i, :len(faces)] = faces

        state[b, 0, :, 0] = waypts[0]
        state[b, 1, :, 0] = waypts[-1]
        if not rest_to_rest:
            state[b, 0, :, 1] = rng.uniform(-0.5, 0.5, size=3)
            state[b, 0, :, 2] = rng.uniform(-0.3, 0.3, size=3)

        tlb = quintic_time_bounds(waypts, cfg.max_vel, cfg.max_acc)
        times[b, :L] = tlb * time_slack

    return ScenarioBatch(state=state, hpolys=hpolys, times=times, seg=segs)


def fill_faces(sc: ScenarioBatch, seed: int = 0,
               offset: float = 100.0) -> ScenarioBatch:
    """The same batch with every face slot of every active segment in use:
    the empty slots get random unit normals with offsets `offset` beyond the
    segment's start point, so the added faces are far from the corridor
    and never bind.  A batch with no padded face slot."""
    rng = np.random.default_rng(seed)
    hp = sc.hpolys.copy()
    B, S, F, _ = hp.shape
    for b in range(B):
        for i in range(int(sc.seg[b])):
            empty = np.linalg.norm(hp[b, i, :, :3], axis=-1) == 0
            k = int(empty.sum())
            if k:
                center = sc.state[b, 0, :, 0]
                hp[b, i, empty] = _slant_faces(center, offset, k, rng)
    return sc._replace(hpolys=hp)
