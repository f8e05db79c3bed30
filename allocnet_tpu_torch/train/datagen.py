"""Synthetic obstacle maps for the corridor front end: random pillars and
random clutter (pillars, boxes, a wall with an opening).

The map builders of `allocnet_tpu/train/datagen.py`, copied (NumPy); the
dataset generation and certification there are not ported yet.
"""

from __future__ import annotations

import numpy as np


def random_pillar_map(seed: int, extent=(20.0, 20.0, 4.0), n_pillars=8,
                      radius=0.3) -> np.ndarray:
    """Synthetic obstacle cloud (stand-in for M3ED crops)."""
    rng = np.random.default_rng(seed)
    pts = []
    ex = np.asarray(extent)
    for _ in range(n_pillars):
        c = rng.uniform([2, 2, 0], [ex[0] - 2, ex[1] - 2, 0], size=3)
        for zz in np.linspace(0, ex[2], 24):
            ang = np.linspace(0, 2 * np.pi, 10, endpoint=False)
            pts.append(np.stack([c[0] + radius * np.cos(ang),
                                 c[1] + radius * np.sin(ang),
                                 np.full(10, zz)], axis=1))
    return np.concatenate(pts)


def random_obstacle_map(seed: int, extent=(20.0, 20.0, 4.0)) -> np.ndarray:
    """Varied synthetic clutter: pillars of random radius, axis-aligned box
    walls, and floating slabs.  Broader corridor-shape distribution than
    random_pillar_map (narrow gaps, overhangs, wall openings) for training
    data diversity; density randomized per seed."""
    rng = np.random.default_rng(seed)
    ex = np.asarray(extent)
    pts = []

    for _ in range(int(rng.integers(5, 14))):
        c = rng.uniform([2, 2, 0], [ex[0] - 2, ex[1] - 2, 0], size=3)
        radius = rng.uniform(0.2, 0.7)
        for zz in np.linspace(0, ex[2], 24):
            ang = np.linspace(0, 2 * np.pi, 12, endpoint=False)
            pts.append(np.stack([c[0] + radius * np.cos(ang),
                                 c[1] + radius * np.sin(ang),
                                 np.full(12, zz)], axis=1))

    # box obstacles: dense surface sampling of random cuboids
    for _ in range(int(rng.integers(0, 4))):
        c = rng.uniform([3, 3, 0.5], [ex[0] - 3, ex[1] - 3, ex[2] - 1])
        half = rng.uniform([0.3, 0.3, 0.3], [1.2, 1.2, 1.0])
        lo_b, hi_b = c - half, c + half
        g = [np.linspace(lo_b[k], hi_b[k], max(2, int(6 * half[k]))) for k in range(3)]
        for axis in range(3):
            for side in (lo_b[axis], hi_b[axis]):
                u, v = [k for k in range(3) if k != axis]
                uu, vv = np.meshgrid(g[u], g[v])
                face = np.zeros((uu.size, 3))
                face[:, u] = uu.ravel()
                face[:, v] = vv.ravel()
                face[:, axis] = side
                pts.append(face)

    # a wall with an opening (forces up-and-over or through-the-gap routes)
    if rng.random() < 0.5:
        wx = rng.uniform(6, ex[0] - 6)
        gap_c = rng.uniform([3, 0.8], [ex[1] - 3, ex[2] - 0.8])
        gap_r = rng.uniform(1.0, 2.0)
        ys = np.linspace(0, ex[1], 60)
        zs = np.linspace(0, ex[2], 16)
        yy, zz = np.meshgrid(ys, zs)
        keep = (np.abs(yy - gap_c[0]) > gap_r) | (np.abs(zz - gap_c[1]) > gap_r * 0.6)
        wall = np.stack([np.full(keep.sum(), wx), yy[keep], zz[keep]], axis=1)
        pts.append(wall)

    return np.concatenate(pts)
