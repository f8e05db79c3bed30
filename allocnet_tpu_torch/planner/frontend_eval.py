#!/usr/bin/env python3
"""The front end's latency and quality evals at the deploy point, on the
card.

The port's counterpart of `scripts/bench_frontend_latency.py` and
`scripts/bench_frontend.py`, on the same maps (`random_obstacle_map`,
20 x 20 x 4 m, voxel 0.25 m, dilation 2, the native collision grid) and
the same start/goal draws (`scenario_stream`):

- `latency_curve`: maps 200-204 x 10 pairs, route seed k, plain RRT at
  5,000 iterations and Informed RRT* at caps 1k / 2.5k / 5k / 10k / 40k:
  found, wall p50 / p95, mean path length on the common-found set.
- `quality`: bench_frontend.py's rrt and rrt_star (40,000 iterations)
  routes of the same 50 scenarios at `QPConfig(res=10)`, with the corridor
  rejects (`sfc.convex_cover` + `sfc.short_cut` longer than max_seg).  Its
  routes are the curve's `rrt` and `rrt_star_40000` calls (same map, seed
  and configuration, asserted), so it reuses them when given.
- `cold_plan`: maps 210-211 x 10 pairs, route seed 1000 + k, the online
  front end (`CorridorConfig.online()`): per plan the host wall of the
  route search (`path`), the fused corridor (`corridor`, a plan longer
  than max_seg is dropped) and the driver's cold tick (`net_qp`, the
  shipped seq5 ConvLSTM), each phase ending in a fetch to the host.  The
  first plan carries the kernels' first use and is left out of the
  statistics, as the script leaves out its compile.  On the card one plan
  is traced under `torch.profiler`: device busy ms, idle share and
  launches per phase, K1 (`admm_chunk`) and L1 (`ldl_block`) by name.
- `cold_plan_pipelined`: the same plans through
  `planner.plan_cold_pipelined` (no host sync between corridor and tick).

GATES hold the outcomes against the JAX package's CPU run of the same
functions (REFERENCE, made by `tests/jax_frontend_record.py`), scenario by
scenario, so that a cut run is gated on what it ran; the JAX CPU run
against the records (`runs/frontend/latency_curve.json`, `results.json`)
on a whole run.  Times have no gate.

    python -m allocnet_tpu_torch.planner.frontend_eval [--device cpu]
        [--cold-only] [--maps K] [--pairs P] [--max-cap C] [--out PATH]

One JSON line per part, the summary last (without the per-scenario
arrays, which go to `--out`, by default OUT in the repository's
git-ignored output directory).  Runs on the card unless `--device` says
otherwise; exits 1 when a gate fails.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import sys
import time

import numpy as np
import torch

from allocnet_tpu_torch import config
from allocnet_tpu_torch.config import AllocNetConfig, QPConfig
from allocnet_tpu_torch.models import weights
from allocnet_tpu_torch.models.networks import ConvLSTMAllocNet
from allocnet_tpu_torch.ops import admm_chunk, ldl
from allocnet_tpu_torch.planner import driver as driver_lib
from allocnet_tpu_torch.planner import planner, sfc
from allocnet_tpu_torch.planner.drive_eval import NET, ROOT, build_eval_map
from allocnet_tpu_torch.utils import witness
from allocnet_tpu_torch.utils.device import device_line, resolve_device
from allocnet_tpu_torch.utils.timing import PhaseTimer

OUT = os.path.join(ROOT, "chiprun_out", "frontend_eval.json")
REFERENCE = os.path.join(ROOT, "tests", "records", "frontend_jax_cpu.json")
CURVE_RECORD = os.path.join(ROOT, "runs", "frontend", "latency_curve.json")
QUALITY_RECORD = os.path.join(ROOT, "runs", "frontend", "results.json")
CURVE_MAPS = (200, 201, 202, 203, 204)
COLD_MAPS = (210, 211)
PER_MAP = 10
MIN_DIST = 10.0
ITER_CAPS = (1000, 2500, 5000, 10000, 40000)
RRT_ITERS = 5000               # the plain-RRT arm's cap (config.py:247)
STAR_ITERS = 40000             # bench_frontend.py's rrt_star cap
COLD_SEED0 = 1000
QUALITY_CFG = AllocNetConfig(qp=QPConfig(res=10))
PHASES = ("path", "corridor", "net_qp")
PARTS = ("curve", "quality", "cold_plan", "cold_plan_pipelined")
# the gates.  The route search is the same C++ source on the host on both
# sides, so found flags, path lengths and rejects are held equal (lengths
# to LEN_RTOL relative: the simplified route is the same points).  A cold
# plan's solved flag may part from the JAX CPU run's only on a plan whose
# JAX flag flips under a +-1e-6 relative move of its inputs (the record's
# `flips`), on at most MAX_FLAG_DIFFS plans.  The card's corridors are
# held to CORRIDOR_TOL of the largest entry of the port's CPU corridors,
# faces as sets (FIRI's face order is a recorded divergence), or else,
# on at most MAX_CORRIDOR_DIFFS plans, witnessed as rounding-decided: the
# CPU's own corridor moves beyond that under one of CORRIDOR_DRAWS draws
# of the route moved by WITNESS_REL of itself, a random sign per entry
# (`corridor_moves`).  Added after the first run on the card, where plan
# 16's corridor (a gap plan) had another face count on the card than on
# the CPU, whose own corridor of that plan moves in every such draw while
# plan 10's moves in none (tests/test_torch_frontend_eval.py,
# test_corridor_witness).
LEN_RTOL = 1e-6
MAX_FLAG_DIFFS = 1
CORRIDOR_TOL = 1e-3
MAX_CORRIDOR_DIFFS = 1
CORRIDOR_DRAWS = 6
WITNESS_REL = witness.REL
WITNESS_SEED = 7
# differences of the JAX CPU run (REFERENCE) from the TPU records, each
# with what is known of it; the record gate demands equality elsewhere
_NOT_ON_CPU = (
    "the TPU record has 9 of the same 11 plans solved, the JAX package's "
    "CPU run 7 (k 7, 11, 15 and 16 unsolved). Not reproduced off the TPU: "
    "tests/jax_frontend_record.py explain gives the same 7, flag for flag, "
    "with bfloat16 operands in every matmul and convolution outside the "
    "float32 blocks (the TPU's default precision), with the Pallas ADMM "
    "kernel (interpret mode) in place of the XLA scan, with both, and with "
    "the record's point buckets; the record keeps no per-plan flags")
EXPLAINED = {"cold_plan_deploy.solved_frac": _NOT_ON_CPU,
             "cold_plan_pipelined.solved_frac": _NOT_ON_CPU}


def path_len(route) -> float:
    return float(np.linalg.norm(np.diff(route, axis=0), axis=1).sum())


def scenario_stream(map_seeds, per_map, min_dist=MIN_DIST, device=None):
    """(pmap, start, goal) per scenario, as the scripts draw them: per map
    (index m) `default_rng(m)`, start and goal uniform in [1, 19]^2 x [0.8,
    3.2], a pair rejected when closer than min_dist or when either end is
    blocked on the native grid; per_map pairs a map."""
    for m, seed in enumerate(map_seeds):
        pmap = build_eval_map(seed, device=device)
        rng = np.random.default_rng(m)
        done = 0
        while done < per_map:
            start = rng.uniform([1, 1, 0.8], [19, 19, 3.2])
            goal = rng.uniform([1, 1, 0.8], [19, 19, 3.2])
            if (np.linalg.norm(goal - start) < min_dist
                    or pmap.native.blocked(start)
                    or pmap.native.blocked(goal)):
                continue
            yield pmap, start, goal
            done += 1


def _stream(map_seeds, pairs, device):
    """(k, pmap, start, goal) of the first `pairs` of each map's PER_MAP,
    k the index in the whole stream (the route seed's offset), so that a
    cut runs the whole run's scenarios with their seeds."""
    for k, (pmap, start, goal) in enumerate(scenario_stream(
            map_seeds, PER_MAP, device=device)):
        if k % PER_MAP < pairs:
            yield k, pmap, start, goal


def curve_arms(cfg: AllocNetConfig, max_cap: int = ITER_CAPS[-1]) -> dict:
    """{arm name: CorridorConfig}: plain RRT at RRT_ITERS, Informed RRT*
    at each of ITER_CAPS up to max_cap."""
    arms = {"rrt": dataclasses.replace(cfg.corridor, use_rrt_star=False,
                                       rrt_max_iter=RRT_ITERS)}
    for cap in ITER_CAPS:
        if cap <= max_cap:
            arms[f"rrt_star_{cap}"] = dataclasses.replace(
                cfg.corridor, use_rrt_star=True, rrt_max_iter=cap)
    return arms


def _pcts(w) -> dict:
    w = np.asarray(w, float) * 1e3
    return {"wall_ms_p50": float(np.percentile(w, 50)),
            "wall_ms_p95": float(np.percentile(w, 95))}


def latency_curve(cfg: AllocNetConfig = config.DEPLOY,
                  maps=CURVE_MAPS, pairs: int = PER_MAP,
                  max_cap: int = ITER_CAPS[-1], device=None):
    """The curve (bench_frontend_latency.py:73-104) over the first `pairs`
    of each map's scenarios.  Returns (summary, routes): the summary has
    the script's fields per arm (unrounded), the scenarios run (`ks`) and
    per arm each scenario's path length (None when not found);
    routes = {"cfg": {arm: CorridorConfig}, "maps", "route": {arm: {k:
    route}}, "wall": {arm: {k: s}}}, for `quality`."""
    arms = curve_arms(cfg, max_cap)
    routes = {"cfg": arms, "maps": tuple(maps),
              "route": {a: {} for a in arms}, "wall": {a: {} for a in arms}}
    ks, scen = [], []
    for k, pmap, start, goal in _stream(maps, pairs, device):
        ks.append(k)
        scen.append([start.tolist(), goal.tolist()])
        for name, ccfg in arms.items():
            t0 = time.perf_counter()
            route = planner.search_route(pmap, start, goal, ccfg, seed=k)
            routes["wall"][name][k] = time.perf_counter() - t0
            routes["route"][name][k] = route
    lens = {a: [None if routes["route"][a][k] is None
                else path_len(routes["route"][a][k]) for k in ks]
            for a in arms}
    L = {a: np.asarray([np.nan if v is None else v for v in lens[a]])
         for a in arms}
    common = ~np.any([np.isnan(L[a]) for a in arms], axis=0)
    base = L["rrt"][common].mean() if common.any() else np.nan
    out = {"n_scenarios": len(ks), "common_found": int(common.sum()),
           "arms": {}, "ks": ks, "scenarios": scen, "lengths": lens}
    for a in arms:
        mean = L[a][common].mean() if common.any() else np.nan
        out["arms"][a] = {
            "found": int((~np.isnan(L[a])).sum()),
            **_pcts(list(routes["wall"][a].values())),
            "mean_path_len_m": None if np.isnan(mean) else float(mean),
            "len_reduction_vs_rrt": (None if np.isnan(mean) else
                                     float(1.0 - mean / base))}
    return out, routes


def quality(cfg: AllocNetConfig = QUALITY_CFG, maps=CURVE_MAPS,
            pairs: int = PER_MAP, routes=None, device=None) -> dict:
    """bench_frontend.py:40-112 over the first `pairs` of each map's
    scenarios: per front end (rrt, rrt_star) found, mean and median path
    length on the pairwise common set, corridor rejects (convex_cover +
    short_cut on `device` longer than max_seg), wall p50 / p95, and the
    per-scenario reduction.  With `routes` (latency_curve's) the routes
    and their walls are the curve's `rrt` and `rrt_star_40000` arms,
    whose configurations, maps and seeds must be this function's (the
    same calls); without, it searches them."""
    fronts = {
        "rrt": ("rrt", dataclasses.replace(
            cfg.corridor, use_rrt_star=False,
            rrt_max_iter=cfg.corridor.rrt_max_iter)),
        "rrt_star": (f"rrt_star_{STAR_ITERS}", dataclasses.replace(
            cfg.corridor, use_rrt_star=True, rrt_max_iter=STAR_ITERS))}
    if routes is not None:
        assert tuple(routes["maps"]) == tuple(maps), "other maps"
        for arm, ccfg in fronts.values():
            assert routes["cfg"][arm] == ccfg, f"{arm}: another search"
    lens = {f: [] for f in fronts}
    polys_n = {f: [] for f in fronts}
    walls = {f: [] for f in fronts}
    ks = []
    for k, pmap, start, goal in _stream(maps, pairs, device):
        ks.append(k)
        for f, (arm, ccfg) in fronts.items():
            if routes is not None:
                assert k in routes["route"][arm], f"scenario {k} not searched"
                route, wall = routes["route"][arm][k], routes["wall"][arm][k]
            else:
                t0 = time.perf_counter()
                route = planner.search_route(pmap, start, goal, ccfg, seed=k)
                wall = time.perf_counter() - t0
            walls[f].append(wall)
            if route is None:
                lens[f].append(None)
                polys_n[f].append(None)
                continue
            lens[f].append(path_len(route))
            polys = sfc.convex_cover(route, pmap.surf, pmap.lo, pmap.hi,
                                     ccfg, device=device)
            polys_n[f].append(len(sfc.short_cut(polys, device=device)))
    both = [i for i in range(len(ks))
            if all(lens[f][i] is not None for f in fronts)]
    out = {"n_scenarios": len(ks), "ks": ks, "reused_curve_routes":
           routes is not None, "lengths": lens, "polys": polys_n}
    for f in fronts:
        v = np.asarray([lens[f][i] for i in both], float)
        out[f] = {"found": sum(x is not None for x in lens[f]),
                  "mean_path_len_m": float(v.mean()) if len(v) else None,
                  "median_path_len_m": float(np.median(v)) if len(v)
                  else None,
                  "long_corridor_rejects": sum(
                      n is not None and n > cfg.qp.max_seg
                      for n in polys_n[f]),
                  **_pcts(walls[f])}
    if both:
        out["path_len_reduction"] = 1.0 - (out["rrt_star"]["mean_path_len_m"]
                                           / out["rrt"]["mean_path_len_m"])
        per = 1.0 - (np.asarray([lens["rrt_star"][i] for i in both])
                     / np.asarray([lens["rrt"][i] for i in both]))
        out["per_scenario_reduction"] = {
            "p50": float(np.percentile(per, 50)),
            "p90": float(np.percentile(per, 90)),
            "max": float(per.max()),
            "frac_improved_over_1pct": float((per > 0.01).mean())}
    return out


def load_net(device=None) -> ConvLSTMAllocNet:
    """ConvLSTMAllocNet(5, 256, 0.5) with the shipped seq5 weights (NET) on
    `device`: the script's net (its :210), which stops at token > 0.5 as
    every imported LSTM does."""
    net = ConvLSTMAllocNet(5, 256, token_thresh=0.5)
    net.load_state_dict(weights.load_params(NET))
    return net.to(resolve_device(device)).eval()


def _state9(start, goal) -> np.ndarray:
    st9 = np.zeros((1, 2, 3, 3), np.float32)
    st9[0, 0, :, 0] = start
    st9[0, 1, :, 0] = goal
    return st9


def corridor_moves(pmap, route, k, cfg) -> int:
    """How many of CORRIDOR_DRAWS draws of `route` moved by WITNESS_REL of
    itself (a random sign per entry, seeded by plan k) give a CPU
    corridor (the online front end's) that is not within CORRIDOR_TOL of
    the CPU corridor of `route` itself (`witness.corridor_moves`, one
    round)."""
    args = (pmap.surf, pmap.lo, pmap.hi, cfg.corridor.online(), cfg.qp)
    corridors = lambda routes: [
        (True, *sfc.corridor_online(r, *args, device="cpu")[:2])
        for r in routes]
    return witness.corridor_moves(corridors, route, WITNESS_SEED + k,
                                  CORRIDOR_DRAWS, CORRIDOR_DRAWS,
                                  CORRIDOR_TOL)


def _plan_phases(pmap, start, goal, k, cfg, cold, dev, timer=None):
    """One cold plan's three phases (each ended by the fetch its result
    needs on the host).  Returns (route as searched, hp, seg, refined goal,
    solved, outputs of the cold tick), solved None when the plan is
    dropped."""
    online = cfg.corridor.online()
    timer = timer or PhaseTimer()
    with timer.phase("path"):
        route = planner.search_route(pmap, start, goal, online,
                                     seed=COLD_SEED0 + k)
    if route is None:
        return (None,) * 6
    with timer.phase("corridor"):
        hp, seg, _, goal_r = sfc.corridor_online(
            route, pmap.surf, pmap.lo, pmap.hi, online, cfg.qp, device=dev)
    if seg > cfg.qp.max_seg:
        return route, hp, seg, goal_r, None, None
    with timer.phase("net_qp"):
        out = cold(torch.as_tensor(_state9(start, goal_r), device=dev),
                   torch.as_tensor(hp, dtype=torch.float32,
                                   device=dev)[None],
                   torch.as_tensor([seg], device=dev))
        solved = bool(out[0][0])
    return route, hp, seg, goal_r, solved, out


def trace_plan(pmap, start, goal, k, cfg, cold, dev) -> dict:
    """One cold plan with each phase under its own `torch.profiler`
    session (`profile_solve.profile_device`, after one discarded
    session): per phase wall, device busy ms, idle share, launches, and
    K1's and L1's device ms and launches."""
    from allocnet_tpu_torch.utils import profile_solve

    online = cfg.corridor.online()
    box = {}

    def prof(name, fn):
        with contextlib.redirect_stdout(io.StringIO()):
            st = profile_solve.profile_device(
                lambda: box.__setitem__(name, fn()), 1, 0, "plan", name)
        return {"wall_ms": st["wall_ms"], "busy_ms": st["busy_ms"],
                "idle": st["idle"], "launches": st["launches"],
                "k1_ms": st["admm_chunk_kernel"][0],
                "k1_launches": st["admm_chunk_kernel"][1],
                "l1_ms": st["ldl_block_kernel"][0],
                "l1_launches": st["ldl_block_kernel"][1]}

    prof("discarded", lambda: None)
    out = {"k": k}
    out["path"] = prof("path", lambda: planner.search_route(
        pmap, start, goal, online, seed=COLD_SEED0 + k))
    route = box["path"]
    out["corridor"] = prof("corridor", lambda: sfc.corridor_online(
        route, pmap.surf, pmap.lo, pmap.hi, online, cfg.qp, device=dev))
    hp, seg, _, goal_r = box["corridor"]
    args = (torch.as_tensor(_state9(start, goal_r), device=dev),
            torch.as_tensor(hp, dtype=torch.float32, device=dev)[None],
            torch.as_tensor([seg], device=dev))
    out["net_qp"] = prof("net_qp", lambda: bool(cold(*args)[0][0]))
    out["solved"] = box["net_qp"]
    return out


def cold_plan(cfg: AllocNetConfig = config.DEPLOY, net=None, params=None,
              maps=COLD_MAPS, pairs: int = PER_MAP, device=None) -> dict:
    """bench_frontend_latency.py:107-169: per plan the host ms of path,
    corridor and net_qp (the driver's cold tick at `rate_hz` 10), the
    plan's K1 and L1 launches and, on the card, its corridor against the
    port's CPU corridor (faces as sets, of the CPU's largest entry).
    Statistics leave out the first kept plan.  On the card the first plan
    of the statistics is traced (`trace_plan`).  On the card raises unless every plan
    launched both kernels."""
    dev = resolve_device(device)
    net = load_net(dev) if net is None else net
    cold = driver_lib.make_cold_tick(net, cfg, params, rate_hz=10.0)
    k1, l1 = admm_chunk.admm_chunk, ldl.ldl_block
    plans, rows, scen = [], [], {}
    for k, pmap, start, goal in _stream(maps, pairs, dev):
        scen[k] = (pmap, start, goal)
        pt = PhaseTimer()
        n0, m0 = k1.launches, l1.launches
        route, hp, seg, _, solved, _ = _plan_phases(pmap, start, goal, k,
                                                    cfg, cold, dev, pt)
        plan = {"k": k, "route": route is not None,
                "seg": None if seg is None else int(seg), "solved": solved,
                "k1": k1.launches - n0, "l1": l1.launches - m0}
        if solved is not None:
            s = pt.summary()
            plan.update({ph: s[ph]["mean_ms"] for ph in PHASES})
            if dev.type == "cuda":
                if min(plan["k1"], plan["l1"]) < 1:
                    raise RuntimeError(
                        f"cold plan {k} ran without launching both kernels: "
                        f"admm_chunk {plan['k1']}, ldl_block {plan['l1']}")
                hp_c, seg_c, _, _ = sfc.corridor_online(
                    route, pmap.surf, pmap.lo, pmap.hi, cfg.corridor.online(),
                    cfg.qp, device="cpu")
                d = plan["corridor_vs_cpu"] = witness.corridor_distance(
                    hp, seg, hp_c, seg_c)
                if d is None or d > CORRIDOR_TOL:
                    plan["corridor_moves"] = corridor_moves(pmap, route, k,
                                                            cfg)
            rows.append(plan)
        plans.append(plan)
    rows_t = rows[1:]      # the first carries the first calls and builds
    out = {"plans": plans, "n_plans": len(rows_t),
           "solved_frac": (float(np.mean([r["solved"] for r in rows_t]))
                           if rows_t else None)}
    for ph in PHASES:
        out[ph + "_ms_p50"] = (float(np.percentile([r[ph] for r in rows_t],
                                                   50)) if rows_t else None)
    tot = [sum(r[ph] for ph in PHASES) for r in rows_t]
    out["total_ms_p50"] = float(np.percentile(tot, 50)) if tot else None
    out["total_ms_p95"] = float(np.percentile(tot, 95)) if tot else None
    out["trace"] = None
    if dev.type == "cuda" and rows_t:
        k = rows_t[0]["k"]
        out["trace"] = trace_plan(*scen[k], k, cfg, cold, dev)
    return out


def cold_plan_pipelined(cfg: AllocNetConfig = config.DEPLOY, net=None,
                        params=None, maps=COLD_MAPS, pairs: int = PER_MAP,
                        device=None) -> dict:
    """bench_frontend_latency.py:172-196: the host wall of each plan
    through `planner.plan_cold_pipelined` (the online front end, the
    driver's cold tick), its solved flag and K1 / L1 launches, for the
    plans it keeps; the first kept plan left out of the statistics.  On
    the card raises unless every kept plan launched both kernels."""
    dev = resolve_device(device)
    net = load_net(dev) if net is None else net
    online = dataclasses.replace(cfg, corridor=cfg.corridor.online())
    cold = driver_lib.make_cold_tick(net, online, params, rate_hz=10.0)
    k1, l1 = admm_chunk.admm_chunk, ldl.ldl_block
    plans, rows = [], []
    for k, pmap, start, goal in _stream(maps, pairs, dev):
        n0, m0 = k1.launches, l1.launches
        t0 = time.perf_counter()
        res = planner.plan_cold_pipelined(pmap, start, goal, online, cold,
                                          seed=COLD_SEED0 + k, device=dev)
        wall = time.perf_counter() - t0
        plan = {"k": k, "ok": res[0], "reason": res[1],
                "solved": res[5] if res[0] else None,
                "k1": k1.launches - n0, "l1": l1.launches - m0}
        if res[0]:
            plan["total_ms"] = wall * 1e3
            if dev.type == "cuda" and min(plan["k1"], plan["l1"]) < 1:
                raise RuntimeError(
                    f"pipelined plan {k} ran without launching both "
                    f"kernels: admm_chunk {plan['k1']}, ldl_block "
                    f"{plan['l1']}")
            rows.append(plan)
        plans.append(plan)
    rows_t = rows[1:]      # the first carries the first calls and builds
    tot = [r["total_ms"] for r in rows_t]
    return {"plans": plans, "n_plans": len(rows_t),
            "solved_frac": (float(np.mean([r["solved"] for r in rows_t]))
                            if rows_t else None),
            "total_ms_p50": float(np.percentile(tot, 50)) if tot else None,
            "total_ms_p95": float(np.percentile(tot, 95)) if tot else None}


def _check(checks: dict, name: str, ok: bool, **detail) -> None:
    checks[name] = {"ok": bool(ok), **detail}


def _same_len(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return abs(a - b) <= LEN_RTOL * max(abs(b), 1.0)


def gates(out: dict, ref: dict) -> dict:
    """GATES of a run's parts (`out`: run's dict) against the JAX CPU
    reference `ref`, over the scenarios each part ran; the record gate
    (`record_differences`) only on a whole run.  Returns {"checks":
    {name: {"ok", ...}}, "passed"}."""
    checks = {}
    if out.get("curve"):
        c = out["curve"]
        ref_idx = {tuple(map(tuple, s)): i for i, s in
                   enumerate(ref["curve_scenarios"])}
        bad_scen = [k for k, s in zip(c["ks"], c["scenarios"])
                    if ref_idx.get(tuple(map(tuple, s))) != k]
        _check(checks, "curve_scenarios", not bad_scen, differ=bad_scen)
        for arm, lens in c["lengths"].items():
            want = [ref["curve_lengths"][arm][k] for k in c["ks"]]
            bad = [k for k, a, b in zip(c["ks"], lens, want)
                   if not _same_len(a, b)]
            _check(checks, f"curve_{arm}", not bad, differ=bad,
                   found=c["arms"][arm]["found"],
                   reference_found=sum(w is not None for w in want))
    if out.get("quality"):
        q = out["quality"]
        for f in ("rrt", "rrt_star"):
            rq = ref["quality_per_scenario"][f]
            bad = [k for i, k in enumerate(q["ks"])
                   if not _same_len(q["lengths"][f][i], rq["lengths"][k])
                   or q["polys"][f][i] != rq["polys"][k]]
            _check(checks, f"quality_{f}", not bad, differ=bad,
                   rejects=q[f]["long_corridor_rejects"])
    plans = {p["k"]: p for p in ref["plans"]}
    if out.get("cold_plan"):
        cp = out["cold_plan"]
        kept = [p["k"] for p in cp["plans"] if p["solved"] is not None]
        want = [p["k"] for p in cp["plans"]
                if plans[p["k"]].get("solved") is not None]
        _check(checks, "cold_plans_kept", kept == want, kept=kept,
               reference=want)
        diff = [k for k in kept if k in want
                and plans[k]["solved"] != next(
                    p["solved"] for p in cp["plans"] if p["k"] == k)]
        unwitnessed = [k for k in diff if not plans[k].get("flips")]
        _check(checks, "cold_plan_flags",
               len(diff) <= MAX_FLAG_DIFFS and not unwitnessed, differ=diff,
               unwitnessed=unwitnessed, limit=MAX_FLAG_DIFFS)
        far = [p for p in cp["plans"] if "corridor_vs_cpu" in p]
        bad = [p for p in far if p["corridor_vs_cpu"] is None
               or p["corridor_vs_cpu"] > CORRIDOR_TOL]
        unwitnessed = [p["k"] for p in bad if not p.get("corridor_moves")]
        _check(checks, "corridors_vs_cpu",
               len(bad) <= MAX_CORRIDOR_DIFFS and not unwitnessed,
               differ=[p["k"] for p in bad], unwitnessed=unwitnessed,
               moves={p["k"]: p.get("corridor_moves") for p in bad},
               max=max((p["corridor_vs_cpu"] for p in far
                        if p["corridor_vs_cpu"] is not None), default=None),
               limit=CORRIDOR_TOL)
    if out.get("cold_plan") and out.get("cold_plan_pipelined"):
        split = {p["k"]: p["solved"] for p in out["cold_plan"]["plans"]}
        piped = {p["k"]: p["solved"] for p in
                 out["cold_plan_pipelined"]["plans"]}
        bad = [k for k in split if split[k] != piped.get(k)]
        _check(checks, "pipelined_flags", not bad, differ=bad)
    if out.get("whole"):
        diffs = record_differences(ref)
        _check(checks, "reference_vs_records",
               all(d in EXPLAINED for d in diffs), differ=diffs,
               explained={d: EXPLAINED[d] for d in diffs if d in EXPLAINED})
    return {"checks": checks,
            "passed": all(v["ok"] for v in checks.values())}


def record_differences(ref: dict) -> list:
    """The outcomes in which the JAX CPU run `ref` differs from the TPU
    records: found per arm, common_found, mean path lengths (the curve's
    rounded to 3 decimals as the record), n_plans and solved_frac of both
    cold plans, found, rejects and path lengths of the quality run."""
    with open(CURVE_RECORD) as f:
        rc = json.load(f)
    with open(QUALITY_RECORD) as f:
        rq = json.load(f)
    diffs = []
    if ref["curve"]["common_found"] != rc["curve"]["common_found"]:
        diffs.append("curve.common_found")
    for arm, v in rc["curve"]["arms"].items():
        for key in ("found", "mean_path_len_m", "len_reduction_vs_rrt"):
            if ref["curve"]["arms"][arm][key] != v[key]:
                diffs.append(f"curve.{arm}.{key}")
    for part in ("cold_plan_deploy", "cold_plan_pipelined"):
        ours = ref["cold_plan" if part == "cold_plan_deploy" else part]
        for key in ("n_plans", "solved_frac"):
            if ours[key] != rc[part][key]:
                diffs.append(f"{part}.{key}")
    for f in ("rrt", "rrt_star"):
        for key in ("found", "long_corridor_rejects"):
            if ref["quality"][f][key] != rq[f][key]:
                diffs.append(f"quality.{f}.{key}")
        for key in ("mean_path_len_m", "median_path_len_m"):
            if not _same_len(ref["quality"][f][key], rq[f][key]):
                diffs.append(f"quality.{f}.{key}")
    return diffs


def run(device=None, maps: int | None = None, pairs: int | None = None,
        max_cap: int | None = None, cold_only: bool = False,
        with_quality: bool = True, cut_cold: bool = True, log=print) -> dict:
    """The eval: the curve and the quality run (unless `cold_only`; the
    quality run reuses the curve's routes when the curve has the 40k arm,
    and is left out when `with_quality` is false), then the cold plan and
    the pipelined plan.  `maps` and `pairs` cut the curve's stream (and,
    with `cut_cold`, the cold plans' streams) to its first maps and to the
    first pairs of each map, `max_cap` the curve's arms.
    Logs one JSON line per part; returns the parts, the gates against
    REFERENCE, the device line and each part's seconds."""
    dev = resolve_device(device)
    with open(REFERENCE) as f:
        ref = json.load(f)
    pairs = PER_MAP if pairs is None else pairs
    max_cap = ITER_CAPS[-1] if max_cap is None else max_cap
    curve_maps = CURVE_MAPS[:maps] if maps else CURVE_MAPS
    cold_maps = COLD_MAPS[:maps] if maps and cut_cold else COLD_MAPS
    cold_pairs = pairs if cut_cold else PER_MAP
    out = {"device": device_line(dev), "curve": None, "quality": None,
           "seconds": {}}
    out["whole"] = (not cold_only and with_quality and pairs == PER_MAP
                    and curve_maps == CURVE_MAPS and cold_maps == COLD_MAPS
                    and max_cap == ITER_CAPS[-1])
    if not cold_only:
        t0 = time.perf_counter()
        curve, routes = latency_curve(config.DEPLOY, curve_maps, pairs,
                                      max_cap, device=dev)
        out["curve"] = curve
        out["seconds"]["curve"] = time.perf_counter() - t0
        log(json.dumps({"curve": _brief(curve)}))
        if with_quality:
            t0 = time.perf_counter()
            reuse = routes if max_cap >= STAR_ITERS else None
            out["quality"] = quality(QUALITY_CFG, curve_maps, pairs, reuse,
                                     device=dev)
            out["seconds"]["quality"] = time.perf_counter() - t0
            log(json.dumps({"quality": _brief(out["quality"])}))
    net = load_net(dev)
    t0 = time.perf_counter()
    out["cold_plan"] = cold_plan(config.DEPLOY, net, None, cold_maps,
                                 cold_pairs, device=dev)
    out["seconds"]["cold_plan"] = time.perf_counter() - t0
    log(json.dumps({"cold_plan": _brief(out["cold_plan"])}))
    t0 = time.perf_counter()
    out["cold_plan_pipelined"] = cold_plan_pipelined(
        config.DEPLOY, net, None, cold_maps, cold_pairs, device=dev)
    out["seconds"]["cold_plan_pipelined"] = time.perf_counter() - t0
    log(json.dumps({"cold_plan_pipelined": _brief(
        out["cold_plan_pipelined"])}))
    out["reference"] = os.path.relpath(REFERENCE, ROOT)
    out["gates"] = gates(out, ref)
    log(json.dumps({"gates": out["gates"]}))
    return out


def _brief(part: dict) -> dict:
    """A part without its per-scenario arrays."""
    return {k: v for k, v in part.items()
            if k not in ("ks", "scenarios", "lengths", "polys", "plans")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--cold-only", action="store_true",
                    help="only the cold plan and the pipelined plan")
    ap.add_argument("--maps", type=int, default=None,
                    help="the first K maps of each stream")
    ap.add_argument("--pairs", type=int, default=None,
                    help="the first P pairs of each map")
    ap.add_argument("--max-cap", type=int, default=None,
                    help="the curve's arms up to this iteration cap")
    ap.add_argument("--out", default=OUT)
    a = ap.parse_args(argv)
    out = run(a.device, a.maps, a.pairs, a.max_cap, a.cold_only,
              log=lambda s: print(s, flush=True))
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: _brief(v) if k in PARTS and v else v
                      for k, v in out.items()}))
    return 0 if out["gates"]["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
