"""Scenario and dataset generation: maps -> corridors -> certified
samples -> HDF5 or .npz.

Port of `allocnet_tpu/train/datagen.py` (the counterpart of the
reference's offline pipeline, pcd_segmentation.py + corridor_generator.py
+ rrt3D.py -> dataset.h5).  Works on any point cloud: real clouds via
`points` (utils/pcd.py reads and crops them), or the built-in random maps
(NumPy copies of the JAX module's).  The same seed draws the same (start,
goal) candidates and route seeds as the JAX module.

Reference segment times (the supervised targets `traj_times`) use the
feasibility-aware quintic bound over the corridor's inner waypoints; a
sample is kept only if its QP solves with them (`certify`, through the
admm_chunk kernel on a card).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from allocnet_tpu_torch import config as config_lib
from allocnet_tpu_torch.config import AllocNetConfig
from allocnet_tpu_torch.ops import admm, lp, qp
from allocnet_tpu_torch.utils.device import resolve_device
from allocnet_tpu_torch.utils.scenarios import (ScenarioBatch,
                                                quintic_time_bounds)


# the corridors' dtype (FIRI, overlap and interior LPs); the
# certification solve is float32 whatever it is
CORRIDOR_DTYPE = torch.float32


def _find_interior(hp: torch.Tensor, mask: torch.Tensor):
    """Deepest interior points of a batch of junction polytopes (the JAX
    module's jit-cached `lp.find_interior`; eager here)."""
    return lp.find_interior(hp, mask)


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


def maze_map() -> np.ndarray:
    """A 40 x 20 x 4 m cloud of three full-height walls (x = 10, 20, 30 m)
    with alternating 3 m gaps: a route across it must snake through them,
    so its corridor keeps more than 5 polytopes (the ten-segment flow of
    tests/test_seq10_e2e.py, whose `_maze_map` builds the same points)."""
    pts = []
    ys = np.arange(0.0, 20.0, 0.25)
    zs = np.linspace(0.0, 4.0, 16)
    for xw, gap in [(10.0, (2.0, 5.0)), (20.0, (15.0, 18.0)),
                    (30.0, (2.0, 5.0))]:
        yy = ys[(ys < gap[0]) | (ys > gap[1])]
        g = np.stack(np.meshgrid(yy, zs, indexing="ij"), axis=-1)
        pts.append(np.concatenate([np.full((*g.shape[:2], 1), xw), g],
                                  axis=-1).reshape(-1, 3))
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


def generate(
    cfg: AllocNetConfig,
    n_samples: int,
    out_path: str | None = None,
    points: np.ndarray | None = None,
    extent=(20.0, 20.0, 4.0),
    seed: int = 0,
    time_slack: float = 2.2,
    device=None,
    timer=None,
    record: dict | None = None,
) -> ScenarioBatch:
    """Sample (start, goal) pairs on a map, build corridors, derive
    reference times and keep the samples that certify; optionally write
    them to `out_path` (`dataset.write_scenarios`: .npz, or HDF5, which
    needs h5py).

    Runs on the card unless `device` says otherwise; the corridors are
    CORRIDOR_DTYPE, the certification solve float32.  `timer` (utils/timing.PhaseTimer)
    records the phases map, corridors, interiors and certify.  `record`,
    a dict, receives each candidate chunk as (starts, goals, route seed,
    CorridorPlans) under "chunks", the batch that reached the
    certification under "batch" and its flags under "flags"."""
    from allocnet_tpu_torch.planner import planner as planner_lib
    from allocnet_tpu_torch.planner.sfc import _bucket

    dev = resolve_device(device)
    phase = timer.phase if timer is not None else (
        lambda name: contextlib.nullcontext())
    rng = np.random.default_rng(seed)
    lo = np.zeros(3)
    hi = np.asarray(extent)
    if points is None:
        points = random_pillar_map(seed, extent)
    with phase("map"):
        pmap = planner_lib.build_map(points, lo, hi, device=dev)

    S, F = cfg.qp.max_seg, cfg.qp.max_faces
    state = np.zeros((n_samples, 2, 3, 3))
    hpolys = np.zeros((n_samples, S, F, 4))
    times = np.zeros((n_samples, S))
    segs = np.zeros((n_samples,), np.int32)

    count, attempts = 0, 0
    chunk = 256
    while count < n_samples and attempts < 20 * n_samples:
        # a chunk of candidate (start, goal) pairs; the corridors of the
        # whole chunk go through one batched FIRI call and one overlap-LP
        # call (plan_corridors_batch)
        want = min(chunk, 4 * (n_samples - count))
        cand_s, cand_g = [], []
        while len(cand_s) < want and attempts < 20 * n_samples:
            attempts += 1
            start = rng.uniform(lo + 0.8, hi - 0.8)
            goal = rng.uniform(lo + 0.8, hi - 0.8)
            if np.linalg.norm(goal - start) < 0.4 * np.linalg.norm(hi - lo):
                continue
            cand_s.append(start)
            cand_g.append(goal)
        if not cand_s:
            break
        rseed = int(rng.integers(1 << 30))
        with phase("corridors"):
            plans = planner_lib.plan_corridors_batch(
                pmap, np.asarray(cand_s), np.asarray(cand_g), cfg,
                seed=rseed, device=dev, dtype=CORRIDOR_DTYPE)
        if record is not None:
            record.setdefault("chunks", []).append(
                (np.asarray(cand_s), np.asarray(cand_g), rseed, plans))

        keep = [(st, cp) for st, cp in zip(cand_s, plans)
                if cp.ok and cp.seg >= 1]
        if not keep:
            continue
        # one batched interior-point LP over all junctions of all kept
        # plans (the reference's get_inner_pts, min_traj_opt.py:251-276),
        # its batch bucketed as the JAX module's
        with phase("interiors"):
            K = len(keep)
            inter = np.zeros((K, S - 1, 2 * F, 4))
            for ki, (_, cp) in enumerate(keep):
                for i in range(cp.seg - 1):
                    inter[ki, i] = np.concatenate(
                        [cp.hpolys[i], cp.hpolys[i + 1]])
            flat = inter.reshape(K * (S - 1), 2 * F, 4)
            Bp = _bucket(flat.shape[0])
            if Bp != flat.shape[0]:
                flat = np.concatenate(
                    [flat, np.zeros((Bp - flat.shape[0],) + flat.shape[1:])])
            mask = np.linalg.norm(flat[:, :, :3], axis=2) > 1e-6
            pts, _ = _find_interior(
                torch.as_tensor(flat, dtype=CORRIDOR_DTYPE, device=dev),
                torch.as_tensor(mask, dtype=CORRIDOR_DTYPE, device=dev))
            pts = pts.cpu().double().numpy()[:K * (S - 1)].reshape(
                K, S - 1, 3)

        for ki, (start, cp) in enumerate(keep):
            if count >= n_samples:
                break
            state[count, 0, :, 0] = start
            state[count, 1, :, 0] = cp.route[-1]
            hpolys[count] = cp.hpolys
            segs[count] = cp.seg
            waypts = [start]
            for i in range(cp.seg - 1):
                waypts.append(pts[ki, i])
            waypts.append(cp.route[-1])
            tlb = quintic_time_bounds(np.asarray(waypts),
                                      cfg.qp.max_vel, cfg.qp.max_acc)
            times[count, :cp.seg] = np.maximum(tlb, 0.3) * time_slack
            count += 1

    sc = ScenarioBatch(state=state[:count], hpolys=hpolys[:count],
                       times=times[:count], seg=segs[:count])
    with phase("certify"):
        keep = certified(cfg, sc, device=dev)
    if record is not None:
        record.update(batch=sc, flags=keep)
    sc = ScenarioBatch(*(a[keep] for a in sc))
    if out_path is not None:
        from allocnet_tpu_torch.train import dataset as ds_lib
        ds_lib.write_scenarios(out_path, sc)
    return sc


def certify_solve(cfg: AllocNetConfig, sc: ScenarioBatch, device=None):
    """The QP solution behind `certified` (a non-empty batch): each
    sample's QP with its reference times at `config.CERTIFY_SOLVER`, in
    float32 (the kernel on a card), the batch bucketed as the JAX
    module's (padding repeats sample 0; the solution keeps the padded
    rows)."""
    from allocnet_tpu_torch.planner.sfc import _bucket

    B = sc.state.shape[0]
    dev = resolve_device(device)
    Bp = _bucket(B)
    pad = lambda a: np.concatenate(
        [a, np.repeat(a[:1], Bp - B, axis=0)]) if Bp != B else a
    f32 = np.float32
    data = qp.build_qp(cfg.qp, pad(sc.state).astype(f32),
                       pad(sc.hpolys).astype(f32), pad(sc.times).astype(f32),
                       pad(sc.seg), device=dev)
    return admm.solve_qp(data, config_lib.CERTIFY_SOLVER)


def certified(cfg: AllocNetConfig, sc: ScenarioBatch,
              device=None) -> np.ndarray:
    """(B,) bool: whether each sample's QP solves with its reference times
    (`certify_solve`)."""
    B = sc.state.shape[0]
    if B == 0:
        return np.zeros((0,), bool)
    return certify_solve(cfg, sc, device).solved.cpu().numpy()[:B]


def solved_in_f64(cfg: AllocNetConfig, sc: ScenarioBatch, sol,
                  scfg=None) -> np.ndarray:
    """(B,) bool: whether the first B rows of a certification solve's
    solution `sol` (physical coefficients and multipliers, any device)
    pass the solver's solved test (of `scfg`, CERTIFY_SOLVER by default)
    when re-evaluated in float64 on the CPU against the QP of the same
    float32 inputs."""
    B = sc.state.shape[0]
    f64 = lambda a: a.astype(np.float32).astype(np.float64)
    d = qp.build_qp(cfg.qp, f64(sc.state), f64(sc.hpolys), f64(sc.times),
                    sc.seg, device="cpu")
    x = qp.scale_coeffs(d, sol.coeffs[:B].cpu().double())
    nu = sol.nu[:B].cpu().double()
    lam = qp.tree_flat({k: v[:B].cpu().double() for k, v in sol.lam.items()},
                       admm.INEQ_KEYS)
    beq = qp.tree_flat(qp.eq_rhs(d), admm.EQ_KEYS)
    h = qp.tree_flat(qp.ineq_rhs(d), admm.INEQ_KEYS)
    pri, dua, pri_sc, dua_sc = admm._full_residuals(d, x, nu, lam, beq, h,
                                                    with_scales=True)
    s = config_lib.CERTIFY_SOLVER if scfg is None else scfg
    obj = qp.objective(d, x)
    return ((pri < s.eps_abs * 10 + s.eps_rel * 10 * pri_sc)
            & (dua < s.eps_abs * 10 + s.eps_rel * 10 * dua_sc)
            & (obj < s.obj_max) & (obj > s.obj_min)).numpy()


def certify(cfg: AllocNetConfig, sc: ScenarioBatch,
            device=None) -> ScenarioBatch:
    """Keep only samples whose QP solves with the reference times
    (`certified`): an unsolvable reference time vector is a corrupt
    supervision target.  (The reference has no such check; its training
    routes those samples to the fallback loss every epoch.)"""
    keep = certified(cfg, sc, device)
    return ScenarioBatch(state=sc.state[keep], hpolys=sc.hpolys[keep],
                         times=sc.times[keep], seg=sc.seg[keep])
