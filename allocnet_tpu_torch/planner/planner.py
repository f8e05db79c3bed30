"""Full planner: map + goal -> corridor -> learned times -> QP ->
trajectory.

Port of `allocnet_tpu/planner/planner.py` (LearningPlanner, learning_
planner.hpp:243-306, and the plan() flow of learning_planning.cpp:143-188,
without ROS).  The host runs the route search and corridor bookkeeping;
the device runs the voxel dilation, FIRI, the overlap LPs, the network and
the QP.

`build_map(native=True)` builds and loads the C++ runtime
(planner/native.py) and raises if either fails, where the JAX package
falls back to the Python RRT in silence; `native=False` takes the Python
RRT on purpose.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from allocnet_tpu_torch.config import AllocNetConfig
from allocnet_tpu_torch.models.networks import bind
from allocnet_tpu_torch.ops import voxel
from allocnet_tpu_torch.planner import native as native_lib
from allocnet_tpu_torch.planner import pipeline, rrt, sfc, trajectory
from allocnet_tpu_torch.utils.device import resolve_device


class PlannerMap(NamedTuple):
    grid: voxel.VoxelGrid
    surf: np.ndarray       # (N, 3) dilated-surface points (host copy)
    lo: np.ndarray
    hi: np.ndarray
    native: object         # native_lib.NativeGrid, or None for the Python RRT


def build_map(points: np.ndarray, lo, hi, scale: float = 0.25,
              dilate_r: int = 2, safe_dis: float = 0.5, native: bool = True,
              device=None) -> PlannerMap:
    """Point cloud -> dilated voxel map and surface cloud (the map
    callback, learning_planning.cpp:115-141), with the C++ collision grid
    when `native`.  The grid is dilated on the card unless `device` says
    otherwise."""
    lo = np.asarray(lo, float)
    hi = np.asarray(hi, float)
    size = tuple(int(np.ceil((hi[j] - lo[j]) / scale)) for j in range(3))
    grid = voxel.make_grid(np.asarray(points, np.float32), lo, size, scale,
                           dilate_r, device=device)
    surf = voxel.surf_points_host(grid)
    ngrid = (native_lib.NativeGrid(points, lo, hi, scale=scale,
                                   safe_dis=safe_dis) if native else None)
    return PlannerMap(grid=grid, surf=surf, lo=lo, hi=hi, native=ngrid)


class CorridorPlan(NamedTuple):
    route: np.ndarray            # (K, 3)
    hpolys: np.ndarray           # (S, F, 4) normalized, padded
    seg: int
    ok: bool
    reason: str


def search_route(pmap: PlannerMap, start, goal, ccfg, seed: int = 0):
    """Route search and greedy shortcut: on the native grid Informed RRT*
    (the reference's front end, sfc_gen.hpp:45-114) when
    ccfg.use_rrt_star, else plain RRT; without it the Python RRT.  Returns
    (K, 3) waypoints or None."""
    if pmap.native is not None:
        if ccfg.use_rrt_star:
            route = pmap.native.rrt_star(
                start, goal, step=ccfg.rrt_step, max_iter=ccfg.rrt_max_iter,
                goal_bias=ccfg.rrt_goal_bias, seed=seed,
                time_budget_s=ccfg.rrt_star_time_budget)
        else:
            route = pmap.native.rrt(start, goal, step=ccfg.rrt_step,
                                    max_iter=ccfg.rrt_max_iter,
                                    goal_bias=ccfg.rrt_goal_bias, seed=seed)
        if route is not None:
            route = pmap.native.simplify(route)
    else:
        route = rrt.plan(start, goal, pmap.surf, pmap.lo, pmap.hi,
                         safe_dis=ccfg.safe_distance, step=ccfg.rrt_step,
                         max_iter=ccfg.rrt_max_iter,
                         goal_bias=ccfg.rrt_goal_bias, seed=seed)
        if route is not None:
            route = rrt.simplify(route, pmap.surf, ccfg.safe_distance)
    return route


def plan_corridor(pmap: PlannerMap, start: np.ndarray, goal: np.ndarray,
                  cfg: AllocNetConfig, seed: int = 0, device=None,
                  dtype=torch.float32) -> CorridorPlan:
    """Route and corridor for one (start, goal), through the fused
    corridor (sfc.corridor_online).  Failures as the reference's:
    no_path (learning_planner.hpp:259-262), long_corridor (:287-291)."""
    route = search_route(pmap, start, goal, cfg.corridor, seed)
    empty = np.zeros((cfg.qp.max_seg, cfg.qp.max_faces, 4))
    if route is None:
        return CorridorPlan(np.zeros((0, 3)), empty, 0, False, "no_path")
    hp, seg, _, goal_r = sfc.corridor_online(
        route, pmap.surf, pmap.lo, pmap.hi, cfg.corridor, cfg.qp,
        device=device, dtype=dtype)
    if seg > cfg.qp.max_seg:
        return CorridorPlan(route, empty, seg, False, "long_corridor")
    route = route.copy()
    route[-1] = goal_r
    return CorridorPlan(route, hp, seg, True, "ok")


def plan_cold_pipelined(pmap: PlannerMap, start: np.ndarray,
                        goal: np.ndarray, cfg: AllocNetConfig, cold_tick,
                        seed: int = 0, device=None):
    """Route search, then the fused corridor, then the driver's cold tick
    on the corridor's device outputs, with no host sync in between: the
    cold tick is queued before the host knows whether the corridor is
    valid, and one fetch at the end returns everything (a gap or long
    corridor wastes one small solve).

    cold_tick: driver.make_cold_tick(...) (or Driver._cold): (state9 (1,
    2, 3, 3) f32, hpolys (1, S, F, 4) f32, seg (1,)) -> (solved, plan_c,
    times, adv) on `device` (the card unless it says otherwise).

    Returns (ok, reason, route, hp (S, F, 4), seg, solved, plan_c, times,
    adv), the arrays fetched to the host."""
    dev = resolve_device(device)
    ccfg = cfg.corridor
    route = search_route(pmap, start, goal, ccfg, seed)
    if route is None:
        return (False, "no_path", None) + (None,) * 6
    hp_d, _, seg_d, gap_d, goal_d, state9_d = sfc.corridor_online_dispatch(
        route, pmap.surf, pmap.lo, pmap.hi, ccfg, cfg.qp, device=dev)
    S = cfg.qp.max_seg
    solved, plan_c, times, adv = cold_tick(
        state9_d.float(), hp_d.float()[None], torch.clamp(seg_d, max=S)[None])
    hp, goal_r, plan_h, times_h = (a.cpu().numpy() for a in
                                   (hp_d, goal_d, plan_c, times))
    seg, any_gap, solved_h = int(seg_d), bool(gap_d), bool(solved[0])

    if any_gap or seg > S:
        # drop the speculative solve; a gap plan takes the generic path
        if any_gap:
            hp2, seg2, _, goal2 = sfc.corridor_online(
                route, pmap.surf, pmap.lo, pmap.hi, ccfg, cfg.qp, device=dev)
            if seg2 <= S:
                route = route.copy()
                route[-1] = goal2
                st9 = np.zeros((1, 2, 3, 3), np.float32)
                st9[0, 0, :, 0] = start
                st9[0, 1, :, 0] = goal2
                t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)
                solved, plan_c, times, adv = cold_tick(
                    t(st9, torch.float32), t(hp2, torch.float32)[None],
                    t([seg2], torch.long))
                return (True, "ok", route, hp2, int(seg2), bool(solved[0]),
                        plan_c.cpu().numpy(), times.cpu().numpy(), adv)
        return (False, "long_corridor" if seg > S else "gap",
                route) + (None,) * 6

    route = route.copy()
    route[-1] = goal_r
    return (True, "ok", route, hp, seg, solved_h, plan_h, times_h, adv)


def _refine_goal(route: np.ndarray, last_poly: np.ndarray) -> np.ndarray:
    """Pull the goal inside the last polytope by interpolating toward the
    previous route point (min_traj_opt.py:214-232)."""
    return sfc._refine_goal_host(route, last_poly)


def plan_corridors_batch(pmap: PlannerMap, starts: np.ndarray,
                         goals: np.ndarray, cfg: AllocNetConfig,
                         seed: int = 0, device=None,
                         dtype=torch.float32) -> list:
    """Corridors for many (start, goal) pairs: every FIRI window of every
    plan in one batched call and every shortcut overlap LP in another
    (sfc.convex_cover_many, short_cut_many); routes run serially on the
    host."""
    routes = [search_route(pmap, starts[b], goals[b], cfg.corridor, seed + b)
              for b in range(len(starts))]
    return corridors_of_routes(pmap, routes, cfg, device=device, dtype=dtype)


def corridors_of_routes(pmap: PlannerMap, routes: list, cfg: AllocNetConfig,
                        device=None, dtype=torch.float32) -> list:
    """`plan_corridors_batch` after its route searches: a CorridorPlan per
    route (None: no path)."""
    ccfg = cfg.corridor
    B = len(routes)
    ok_idx = [b for b, r in enumerate(routes) if r is not None]
    covers = sfc.convex_cover_many([routes[b] for b in ok_idx], pmap.surf,
                                   pmap.lo, pmap.hi, ccfg, device=device,
                                   dtype=dtype)
    cuts = sfc.short_cut_many(covers, device=device, dtype=dtype)

    empty = np.zeros((cfg.qp.max_seg, cfg.qp.max_faces, 4))
    out = [CorridorPlan(np.zeros((0, 3)), empty, 0, False, "no_path")
           for _ in range(B)]
    for b, polys in zip(ok_idx, cuts):
        route = routes[b]
        if len(polys) > cfg.qp.max_seg:
            out[b] = CorridorPlan(route, empty, len(polys), False,
                                  "long_corridor")
            continue
        polys = sfc.normalize_polys(polys)
        hp, seg = sfc.to_padded(polys, cfg.qp)
        out[b] = CorridorPlan(_refine_goal(route, polys[-1]), hp, seg, True,
                              "ok")
    return out


class PlanOutput(NamedTuple):
    result: pipeline.PlanResult
    traj: trajectory.Trajectory
    corridor_ok: np.ndarray      # (B,) bool
    reasons: list


def plan_many(pmap: PlannerMap, starts: np.ndarray, goals: np.ndarray,
              net, params, cfg: AllocNetConfig, seed: int = 0,
              refine_steps: int = 0, device=None,
              dtype=torch.float32) -> PlanOutput:
    """A batch of rest-to-rest plans: the corridors (in `dtype`), then one
    batched network and QP solve (pipeline.plan_batch, in the net's dtype)
    for every corridor found.  `params` is a state_dict for `net`, or None
    for the weights it holds; the net must live on `device` (the card
    unless it says otherwise)."""
    dev = resolve_device(device)
    B = len(starts)
    S, F = cfg.qp.max_seg, cfg.qp.max_faces
    hp = np.zeros((B, S, F, 4))
    segs = np.zeros((B,), np.int64)
    oks = np.zeros((B,), bool)
    reasons = []
    state = np.zeros((B, 2, 3, 3))
    for b, cp in enumerate(plan_corridors_batch(pmap, starts, goals, cfg,
                                                seed=seed, device=dev,
                                                dtype=dtype)):
        reasons.append(cp.reason)
        oks[b] = cp.ok
        if cp.ok:
            hp[b] = cp.hpolys
            segs[b] = cp.seg
            state[b, 0, :, 0] = starts[b]
            # the goal snapped to the end of the route found
            # (learning_planner.hpp:264 finState = route.back())
            state[b, 1, :, 0] = cp.route[-1]
        else:
            segs[b] = 1
            hp[b, 0, 0] = [1.0, 0.0, 0.0, 1e3]

    res = pipeline.plan_batch(bind(net, params), cfg.qp, cfg.solver,
                              state.astype(np.float32),
                              hp.astype(np.float32), segs,
                              refine_steps=refine_steps, device=dev)
    traj = trajectory.from_solution(res.coeffs, res.times,
                                    torch.as_tensor(segs, device=dev))
    return PlanOutput(result=res, traj=traj, corridor_ok=oks, reasons=reasons)


def sample_missions(pmap: PlannerMap, cfg: AllocNetConfig, rng, want: int,
                    lo, hi, device=None, dtype=torch.float32) -> list:
    """`want` corridor-feasible missions on a map, sampled as
    scripts/drive_eval.py's `sample_missions` does: start and goal uniform
    0.8 m inside the bounds and at least 0.4 of the diagonal apart, the
    route seed drawn from `rng`.  Returns [(start, goal, route seed,
    CorridorPlan)]; the plan's route ends at the refined goal."""
    lo, hi = np.asarray(lo, float), np.asarray(hi, float)
    out = []
    attempts = 0
    while len(out) < want and attempts < 40 * want:
        attempts += 1
        start = rng.uniform(lo + 0.8, hi - 0.8)
        goal = rng.uniform(lo + 0.8, hi - 0.8)
        if np.linalg.norm(goal - start) < 0.4 * np.linalg.norm(hi - lo):
            continue
        seed = int(rng.integers(1 << 30))
        cp = plan_corridor(pmap, start, goal, cfg, seed=seed, device=device,
                           dtype=dtype)
        if cp.ok and cp.seg >= 1:
            out.append((start, goal, seed, cp))
    return out
